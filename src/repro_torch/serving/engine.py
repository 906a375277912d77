"""Serving engine (port of ``repro.serving.engine``).  Three schedulers:

* ``continuous`` (mixed-variant slot scheduler) — the engine keeps ONE
  persistent decode batch of ``batch_size`` lanes.  Each lane carries its
  own request, bank slot (``variant_idx``; slot 0 = base), decode position
  and token budget.  Every step: free lanes admit queued requests
  (prefill-on-admit, cache rows merged in), every active lane appends its
  pending token (one host sync per step), exhausted lanes retire at once
  and free their lane, and one decode serves the whole mixed batch through
  the banked fused delta GEMM.  Every variant is served fused, from the
  registry's overlay bank.
* ``speculative`` — the continuous slot scheduler with each decode step
  replaced by a base-as-draft round (``serving/speculative.py``): k
  drafts on the base weights, one banked verify of k+1 tokens a lane, up
  to k+1 tokens a lane per round.  The tokens are the continuous
  scheduler's for any k; ``draft_k`` sets the longest draft and
  ``spec_adaptive`` lets an acceptance tracker walk k along the ladder
  (the powers of two up to ``draft_k``, and ``draft_k``).  Sliding-window (ring) caches are refused: a
  rejected draft's write would clobber in-window history.
* ``group`` — pending requests are grouped BY VARIANT (the FIFO head
  decides), and each group runs one prefill over a fixed (batch_size,
  prompt_len) batch plus decode steps up to the largest token budget in
  the group.  Variants resolve to (params, overlay): dense residents pass
  a materialised copy with overlay None; fused residents pass the shared
  base params plus a packed overlay fused into every GEMM.

Compile-once serving (DESIGN.md §14).  The JAX engine runs each step as
one AOT-compiled executable; here, on a card, each fixed-shape step of the
slot scheduler (the decode step, and the speculative round of each draft
length on the ladder) runs as a CUDA graph
(``core/compile_cache.CapturedStep``): captured at its first use or by
``warmup()``, then replayed with one launch a step.  Each step kind comes
in two flavours, with the overlay bank and without it (before the first
variant admission), as the JAX engine's "banked"/"banked-empty" and
"spec"/"spec-empty" executables.  A graph replays fixed addresses, so the
live decode state never moves: one cache from ``Model.init_cache`` into
which every admission wave's rows are merged, the pending tokens and the
lanes' device bank slots are written in place, and whatever a step
rebinds (a cache's ``pos``, a recurrent state) is copied back into them
inside the graph.  A step whose base, bank or state addresses changed is
captured again.  The group scheduler's decode and every prefill run
eagerly; ``warmup()`` runs each once.  With ``graphs=False``, and on the
CPU, every step runs eagerly through the same code, with the same tokens.

Async admission (DESIGN.md §13; ``serving/admission``, the slot schedulers
only): with an ``admission`` pipeline the lane loop never loads a variant.
A request whose version is still ingesting reports ``admitting`` and keeps
its place at the front of the queue; between steps the loop commits at
most one staged variant into its bank slot (``drain(max_admits=1)``),
written in place on the serving stream, so the next replay reads it; with
every queued request behind ingest and no lane live it sleeps on the
pipeline's progress.  ``record_step_times`` appends ``(t_end, seconds,
admission_busy)`` per step or round to ``step_times``.  The engine waits
for the serving stream only (never the whole device), so the staging
stream's copies overlap the steps.

Mesh-sharded serving (DESIGN.md §11-12; ``mesh``, explicit SPMD as
``distributed/sharding.py`` sets out): every rank runs this engine over
the same requests.  Each model call runs inside the mesh context, so the
delta GEMMs launch per rank on the rank's tiles (``kernels/dispatch``;
``kernel_dispatch="gspmd"`` runs the gathered global kernels instead, the
A/B reference).  The lanes split over "data" in blocks (``act_batch``):
a rank prefills and decodes its own lanes' rows against a KV cache of its
lanes and KV heads, and after each step the ranks all-gather the lanes'
next tokens over "data", so every rank's scheduler sees every lane and
makes the same decisions.  Every family serves under a mesh: the
frontend stub's frames or image embeddings are built for the rank's
lanes, and the recurrent families' states and every KV cache hold the
rank's lanes and heads.  An int8 base serves under a mesh as on one
card, and so does async admission (the ranks agree on each commit:
``serving/admission``).  The speculative scheduler serves under a mesh:
each round drafts and verifies the rank's lanes on its blocks
(``serving/speculative``), then the ranks all-gather the lanes' verified
tokens, accept counts and next tokens over the lanes' axes in one
collective, so every rank's acceptance tracker sees the same counts and
walks the ladder in step (a rank that picked another k would make other
collectives).  ``warmup()`` serves under a mesh: every rank runs the same
entries in the same order, each model call inside the mesh context, on
the rank's lanes and its bank's slot ids; the steps stay eager, so every
outcome is "eager", and ``status()["compile_cache"]`` counts the rank's
own loads.  One refusal is left: CUDA graphs on a card, since a gloo
collective cannot be captured (CUDA graphs under a mesh come with a slice
of their own: NCCL, a card a rank).

Pod-local banks (DESIGN.md §17; a registry with ``pod_banks=True`` on a
(pod, data, model) mesh): the lanes split pod-major over ("pod", "data"),
so lane i belongs to pod i // (batch_size // pods), and each pod's ranks
hold only that pod's bank slots.  The affinity router (``_route_pod``)
sends a request to a pod that already holds its variant and has a free
lane (a hit), else to the pod with the most free lanes, which admits it
(a miss); the choice sticks to the request.  The scheduler keeps global
slot ids; once a step, as the lanes' slots reach the device, each lane's
id is translated to its pod's bank (global - pod * bank_size,
``_pod_local``), so the models and kernels index the bank the rank holds.
A lane whose slot lies outside its pod's range raises there, on the host
(the banked kernel traps on an id outside its bank).  An idle lane parks
on its pod's base slot.  ``status()["affinity"]`` counts the router's hits
and misses; ``status()["hbm"]`` adds the bank bytes and residents per pod.
MoE models serve on pod-local banks: a capacity group that crosses the
lanes' split routes on router scores each rank computed for its own rows
from its pod's bank, and runs the banked expert passes on its own pod's
rows alone (``models/moe``), so no slot id reaches a bank that does not
hold it.

``status()["ttft"]`` reports the count, mean and max of the time from
submit to first token over every request, and its p50 and p99 over a
bounded reservoir of the last ``TTFT_SAMPLES`` (the first fill it, each
later one overwrites the oldest, in arrival order: no sampling).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import compile_cache as CC
from repro_torch.device import synchronize, synchronize_stream
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import build
from repro_torch.serving.variants import VariantRegistry
from repro_torch.tree import tree_leaves

TTFT_SAMPLES = 1024     # the TTFT reservoir behind status()'s percentiles


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt (prompt_len,)
    variant: str = "__base__"
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    status: str = "queued"        # queued | admitting | running | done |
                                  # failed
    retries: int = 0
    error: Optional[str] = None
    served_version: Optional[int] = None   # version resolved at admission
    route_pod: Optional[int] = None        # pod-local banks: the routed pod
    first_token_at: Optional[float] = None  # perf_counter at first token
    submitted_at: float = 0.0     # perf_counter at submit()
    drafted: int = 0              # speculative scheduler: drafts offered
    accepted: int = 0             # to this request / accepted by it


@dataclasses.dataclass
class _Slot:
    """One lane of the persistent continuous-batching decode batch."""
    request: Request
    variant_slot: int             # bank slot index (0 for base rows)
    remaining: int                # tokens still owed
    vkey: str = "__base__"        # pinned version key, unpinned at retire
                                  # even if the variant was hot-swapped
    pod: int = 0                  # the pod whose slots the lane decodes


class ServingEngine:
    """Fixed-shape batched serving: ``batch_size`` lanes, prompts padded to
    ``prompt_len``, KV capacity ``max_len``.  ``scheduler`` is
    "continuous" (mixed-variant lanes over the overlay bank),
    "speculative" (the same lanes, decoded by base-as-draft rounds of up
    to ``draft_k`` drafts) or "group" (grouped by variant — required for
    dense residency).  ``graphs`` (on a card) replays the slot
    schedulers' steps as CUDA graphs; False runs them eagerly.
    ``admission`` (an ``AdmissionPipeline``, slot schedulers only) admits
    variants off the serving thread.  ``mesh`` (with a registry placed on
    it) serves over the ranks of a mesh; ``kernel_dispatch`` is
    "shard_map" (per-rank kernels) or "gspmd" (gathered global kernels)."""

    def __init__(self, model, registry: VariantRegistry, *,
                 batch_size: int = 4, prompt_len: int = 32,
                 max_len: int = 128, max_retries: int = 1,
                 scheduler: str = "group", draft_k: int = 4,
                 spec_adaptive: bool = True, graphs: bool = True,
                 admission=None, mesh=None,
                 kernel_dispatch: str = "shard_map"):
        if scheduler not in ("group", "continuous", "speculative"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if kernel_dispatch not in ("shard_map", "gspmd"):
            raise ValueError(f"unknown kernel_dispatch {kernel_dispatch!r}")
        if mesh is not None:
            _refuse_on_mesh(registry, scheduler=scheduler, graphs=graphs)
        # pod-local banks: lanes split evenly across the pods (pod-major)
        self._pods = registry.pods
        if self._pods > 1:
            if scheduler == "speculative":
                raise ValueError(
                    "scheduler='speculative' does not support pod-local "
                    "banks (pod_banks=True): use scheduler='continuous'")
            if mesh is None:
                raise ValueError(
                    "pod-local banks need the engine's mesh (the lanes' "
                    "pods come from their split over the mesh)")
            if batch_size % self._pods:
                raise ValueError(
                    f"batch_size={batch_size} must divide evenly across "
                    f"{self._pods} pods (lanes block-partition pod-major)")
        if admission is not None and scheduler == "group":
            raise ValueError(
                "async admission requires scheduler='continuous' (staged "
                "overlays commit into the overlay bank between decode "
                "steps; the group scheduler admits dense residents inline)")
        if scheduler == "speculative":
            from repro_torch.models.transformer import FAMILIES, layer_pattern
            if model.cfg.family in FAMILIES and any(
                    e["window"] > 0 for e in layer_pattern(model.cfg)):
                raise ValueError(
                    "scheduler='speculative' requires windowless KV "
                    "caches: sliding-window layers ring-buffer their "
                    "writes, so rewinding rejected draft tokens would "
                    "clobber in-window history")
        self.scheduler = scheduler
        self.model = model
        self.registry = registry
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.max_retries = max_retries
        self.admission = admission
        self.device = registry.device
        self.mesh = mesh
        self.kernel_dispatch = kernel_dispatch
        self._mesh_setup(batch_size)
        self._queue: collections.deque[Request] = collections.deque()
        self._done: dict[int, Request] = {}
        self._next_rid = 0
        # continuous-scheduler state (persists across run_until_drained
        # calls: the decode batch is a long-lived object).  Every live
        # tensor is allocated here, once, and written in place after: the
        # cache the prefills' rows merge into, the pending tokens and the
        # lanes' bank slots (idle lanes sit on slot 0, the base)
        self._slots: list[Optional[_Slot]] = [None] * batch_size
        # each lane's pod, and the global slot an idle lane parks on: its
        # pod's base slot
        self._lane_pods = np.array([self._lane_pod(i)
                                    for i in range(batch_size)], np.int64)
        self._base_vidx = (self._lane_pods
                           * registry.bank_size).astype(np.int32)
        self._variant_idx = self._base_vidx.copy()
        self._cache = self._next_tok = self._variant_idx_dev = None
        # speculative rounds: one round function per draft length of the
        # adaptive ladder, each writing its tokens and accept counts into
        # its own buffers
        self.spec = None
        self._rounds = {}
        self._spec_out = {}
        if scheduler in ("continuous", "speculative"):
            with self._ctx():
                self._cache = model.init_cache(self._nloc, max_len,
                                               device=self.device)
            self._next_tok = torch.zeros(batch_size, dtype=torch.int32,
                                         device=self.device)
            self._variant_idx_dev = torch.zeros(
                batch_size, dtype=torch.int32, device=self.device)
        if scheduler == "speculative":
            from repro_torch.serving import speculative as SPEC
            self.spec = SPEC.AcceptanceTracker(draft_k,
                                               adaptive=spec_adaptive)
            self._rounds = {k: SPEC.make_round_fn(model, k)
                            for k in self.spec.ladder}
            self._spec_out = {k: (
                torch.zeros((batch_size, k + 1), dtype=torch.int32,
                            device=self.device),
                torch.zeros(batch_size, dtype=torch.int32,
                            device=self.device)) for k in self.spec.ladder}
        self._vidx_dirty = False
        # captured steps (CUDA graphs): {(flavour, kind): CapturedStep},
        # all in one memory pool
        self.graphs = (graphs and self.device.type == "cuda"
                       and scheduler != "group")
        self._graphs: dict = {}
        self._pool = None
        self.warmed = False
        self.metrics = {"batches": 0, "tokens_generated": 0, "prefills": 0,
                        "failed": 0, "admitted": 0, "retired": 0,
                        "decode_steps": 0,
                        "prefill_seconds": 0.0, "decode_seconds": 0.0,
                        "async_admits": 0,
                        "step_compiles": 0, "step_cache_hits": 0,
                        "step_compile_seconds": 0.0,
                        "warmup_seconds": 0.0,
                        "spec_rounds": 0, "spec_drafted": 0,
                        "spec_accepted": 0,
                        "affinity_hits": 0, "affinity_misses": 0,
                        "ttft_count": 0, "ttft_seconds_sum": 0.0,
                        "ttft_seconds_max": 0.0}
        # warmup registry (extensible: register_warmup), the JAX engine's
        # entries; the banked ones only where the scheduler serves from the
        # bank (warming them means allocating it)
        self._warmup_reg = {"plain": self._warm_plain,
                            "fused": self._warm_fused}
        if scheduler in ("continuous", "speculative"):
            self._warmup_reg["banked"] = self._warm_banked
        if self.spec is not None:
            self._warmup_reg["speculative"] = self._warm_speculative
        # the latest _ttft_cap first-token latencies (seconds)
        self._ttft_cap = TTFT_SAMPLES
        self._ttft_samples: list = []
        # (t_end, seconds, admission_busy) per step or round, when on
        self.record_step_times = False
        self.step_times: list = []

    # -- API -----------------------------------------------------------------
    def submit(self, tokens, variant: str = "__base__",
               max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, tokens=np.asarray(tokens),
                                   variant=variant,
                                   max_new_tokens=max_new_tokens,
                                   submitted_at=time.perf_counter()))
        return rid

    def _note_first_token(self, r: Request) -> None:
        if r.first_token_at is not None:
            return
        r.first_token_at = time.perf_counter()
        ttft = r.first_token_at - r.submitted_at
        n = self.metrics["ttft_count"]
        self.metrics["ttft_count"] = n + 1
        self.metrics["ttft_seconds_sum"] += ttft
        self.metrics["ttft_seconds_max"] = max(
            self.metrics["ttft_seconds_max"], ttft)
        if len(self._ttft_samples) < self._ttft_cap:
            self._ttft_samples.append(ttft)
        else:
            self._ttft_samples[n % self._ttft_cap] = ttft

    def result(self, rid: int) -> Request:
        return self._done[rid]

    def request(self, rid: int) -> Optional[Request]:
        """The Request wherever it lives (done, in a decode lane, or
        queued); None if unknown."""
        if rid in self._done:
            return self._done[rid]
        for s in self._slots:
            if s is not None and s.request.rid == rid:
                return s.request
        for r in self._queue:
            if r.rid == rid:
                return r
        return None

    def status(self, rid: Optional[int] = None):
        """With ``rid``: that request's lifecycle string (never raises).
        Without: the engine snapshot (occupancy, TTFT, metrics)."""
        if rid is not None:
            r = self.request(rid)
            return "unknown" if r is None else r.status
        n = self.metrics["ttft_count"]
        reg = self.registry
        bank = reg.bank
        snap = {"scheduler": self.scheduler, "pending": self.pending(),
                "active": self.active(),
                "warmed": self.warmed,
                # captured steps: graphs held, captures, replays and
                # capture seconds (the JAX engine's executable counters)
                "steps": {"executables": len(self._graphs),
                          "compiles": self.metrics["step_compiles"],
                          "cache_hits": self.metrics["step_cache_hits"],
                          "compile_seconds":
                              self.metrics["step_compile_seconds"]},
                # the kernel library's build cache
                "compile_cache": build.cache_stats(),
                "ttft": {"count": n,
                         "mean_seconds": (self.metrics["ttft_seconds_sum"]
                                          / n if n else 0.0),
                         "max_seconds": self.metrics["ttft_seconds_max"],
                         "p50_seconds": self._ttft_percentile(50),
                         "p99_seconds": self._ttft_percentile(99)},
                "metrics": dict(self.metrics),
                # resident device memory: the base weights (int8 cuts the
                # targets to about a quarter of fp32) next to the bank
                "hbm": {"base_dtype": reg.base_dtype,
                        "base_bytes": reg.base_nbytes(),
                        "base_per_device": reg.base_per_device_nbytes(),
                        "bank_bytes": bank.nbytes() if bank is not None
                        else 0,
                        # per pod: bank bytes and resident version keys
                        "bank_per_pod": (bank.per_pod_nbytes()
                                         if bank is not None else {}),
                        "bank_resident_per_pod": (bank.pod_resident()
                                                  if bank is not None
                                                  else {})},
                # the affinity router: a hit sent a request to a pod that
                # held its variant already (no admission)
                "affinity": {
                    "pods": self._pods,
                    "hits": self.metrics["affinity_hits"],
                    "misses": self.metrics["affinity_misses"],
                    "hit_rate": (self.metrics["affinity_hits"]
                                 / max(1, self.metrics["affinity_hits"]
                                       + self.metrics["affinity_misses"]))}}
        if self.spec is not None:
            snap["speculative"] = self.spec.snapshot()
        if self.mesh is not None:
            from repro_torch.kernels import dispatch as D
            snap["mesh"] = {"shape": dict(zip(self.mesh.axis_names,
                                              self.mesh.shape)),
                            "coords": self.mesh.coords,
                            "backend": self.mesh.backend,
                            "kernel_dispatch": self.kernel_dispatch,
                            "lanes": (self._lo, self._lo + self._nloc),
                            "dispatch": D.memo_info(),
                            "bank_per_device": bank.per_device_nbytes()
                            if bank is not None else {}}
        return snap

    def _ttft_percentile(self, q: float) -> float:
        return (float(np.percentile(self._ttft_samples, q))
                if self._ttft_samples else 0.0)

    def pending(self) -> int:
        return len(self._queue)

    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def run_until_drained(self, max_rounds: int = 1000,
                          max_steps: Optional[int] = None) -> dict:
        """Serve until the queue and every lane are empty.  ``max_steps``
        (slot schedulers) returns after that many decode steps or rounds
        with the lanes live: a caller interleaves control-plane calls
        (publish, update) between slices of serving."""
        if self.scheduler == "continuous":
            self._serve_lanes(max_rounds, self._decode_step, max_steps)
            return self.metrics
        if self.scheduler == "speculative":
            self._serve_lanes(max_rounds, self._spec_round, max_steps)
            return self.metrics
        if max_steps is not None:
            raise ValueError("max_steps needs a slot scheduler "
                             "(continuous or speculative)")
        rounds = 0
        while self._queue and rounds < max_rounds:
            self._serve_one_group()
            rounds += 1
        return self.metrics

    # -- internals -------------------------------------------------------------
    def _take_group(self) -> list:
        """Pop up to batch_size requests of the head's variant; skipped
        requests go back to the front in their original order."""
        if not self._queue:
            return []
        variant = self._queue[0].variant
        group, skipped = [], []
        while self._queue and len(group) < self.batch_size:
            r = self._queue.popleft()
            if r.variant == variant:
                group.append(r)
            else:
                skipped.append(r)
        self._queue.extendleft(reversed(skipped))
        return group

    def _serve_one_group(self) -> None:
        group = self._take_group()
        if not group:
            return
        variant = group[0].variant
        try:
            with self._ctx():
                params, overlay = self.registry.resolve(variant)
            version = self.registry.current_version(variant)
        except Exception as e:  # unknown variant, failed load: retry/fail
            for r in group:
                r.retries += 1
                if r.retries > self.max_retries:
                    r.status, r.error = "failed", str(e)
                    self._done[r.rid] = r
                    self.metrics["failed"] += 1
                else:
                    self._queue.append(r)
            return
        for r in group:
            r.served_version = version
            r.status = "running"

        batch = self._prompt_batch(dict(enumerate(group)))
        t0 = time.perf_counter()
        with self._ctx():
            last_logits, cache = self.model.prefill(params, batch,
                                                    self.max_len,
                                                    overlay=overlay)
        # greedy over the padded vocab, as the JAX engine does
        next_tok = self._all_lanes(
            torch.argmax(last_logits, dim=-1).to(torch.int32))
        synchronize(self.device)
        self.metrics["prefill_seconds"] += time.perf_counter() - t0
        self.metrics["prefills"] += 1

        n_steps = max(r.max_new_tokens for r in group)
        t0 = time.perf_counter()
        for step in range(n_steps):
            host_tok = next_tok.cpu().numpy()   # one host sync per step
            n_active = 0
            for i, r in enumerate(group):
                if step < r.max_new_tokens:
                    r.out_tokens.append(int(host_tok[i]))
                    self._note_first_token(r)
                    n_active += 1
            self.metrics["tokens_generated"] += n_active
            if step + 1 >= n_steps:
                break   # every request has its budget: skip the last decode
            with self._ctx():
                logits, cache = self.model.decode_step(
                    params, self._local_rows(next_tok), cache,
                    overlay=overlay)
            next_tok = self._all_lanes(
                torch.argmax(logits, dim=-1).to(torch.int32))
            self.metrics["decode_steps"] += 1
        synchronize(self.device)
        self.metrics["decode_seconds"] += time.perf_counter() - t0

        for r in group:
            r.status = "done"
            self._done[r.rid] = r
        self.metrics["batches"] += 1

    # -- continuous slot scheduler (mixed-variant batches) -------------------
    def _merge_admitted(self, old: dict, fresh: dict, rows: list) -> dict:
        """Copy the freshly prefilled rows ``rows`` into the live batch
        cache, in place, along each leaf's batch axis
        (``Model.cache_batch_axes``): per-row ``slot_pos`` and ``pos`` make
        every leaf row-separable, so admission is a pure row select."""
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)

        def merge(o, f, axis):
            if isinstance(axis, int):
                o.index_copy_(axis, idx, f.index_select(axis, idx))
            elif isinstance(axis, dict):
                for key, ax in axis.items():
                    merge(o[key], f[key], ax)
            else:
                for o_i, f_i, ax in zip(o, f, axis, strict=True):
                    merge(o_i, f_i, ax)
        merge(old, fresh, self.model.cache_batch_axes())
        return old

    def _lane_pod(self, i: int) -> int:
        """The pod of lane ``i``: the lanes split pod-major over ("pod",
        "data"), so each pod holds a contiguous range."""
        return i // (self.batch_size // self._pods)

    def _route_pod(self, r: Request, free: list) -> int:
        """The affinity router: a pod with a free lane that already holds
        the request's variant (a hit, no admission), else the pod with the
        most free lanes (a miss: it admits the variant).  Base requests
        count as neither.  The choice sticks to the request: under async
        admission the tickets are per (version, pod), and routing a
        request mid-ingest elsewhere would start a second ingest."""
        if self._pods == 1:
            return 0
        if r.route_pod is not None:
            return r.route_pod
        free_per_pod = collections.Counter(self._lane_pod(i) for i in free)
        holding = ([] if r.variant == "__base__"
                   else self.registry.bank_pods_holding(r.variant))
        warm = [p for p in sorted(free_per_pod) if p in holding]
        if warm:
            pod = warm[0]
        else:
            pod = max(sorted(free_per_pod), key=lambda p: free_per_pod[p])
        if r.variant != "__base__":
            self.metrics["affinity_hits" if pod in holding
                         else "affinity_misses"] += 1
        r.route_pod = pod
        return pod

    def _admit_free_slots(self) -> list:
        """Pop queued requests into free lanes: route each request to a
        pod (``_route_pod``; one pod off pod-local banks), resolve its
        variant to a bank slot of that pod (admitting it on a miss) and pin
        it for the request's lifetime.  Unknown variants and failed loads
        re-queue up to max_retries then fail; a fully pinned pod re-queues
        the head and waits for retirements; a request whose pod has no free
        lane waits for one.  Under async admission a variant is never
        loaded here: the pipeline is polled for the routed pod (prefetching
        what it has not seen), a request whose version is still ingesting
        is skipped as ``admitting``, and skipped requests go back to the
        front in their order, so admission stays FIFO once staging
        lands."""
        newly: list = []
        skipped: list = []
        free = [i for i in range(self.batch_size) if self._slots[i] is None]
        while free and self._queue:
            r = self._queue.popleft()
            pod = self._route_pod(r, free)
            if not any(self._lane_pod(i) == pod for i in free):
                # the routed pod's lanes are all busy: wait for one there
                # (routing again would split the request's admission)
                skipped.append(r)
                continue
            if self.admission is not None and r.variant != "__base__":
                try:
                    state = self.admission.poll(r.variant, pod=pod)
                except Exception as e:   # ingest failed: the same retry
                    self._fail_or_requeue(r, e)   # budget as a sync load
                    continue
                if state != "admitted":
                    r.status = "admitting"
                    skipped.append(r)
                    continue
            try:
                # admission-time resolution: the request serves the
                # version the pointer names NOW, and the pin holds that
                # version's slot until it retires
                vslot, vkey = self.registry.bank_acquire(r.variant, pod)
            except RuntimeError:
                # every slot of the pod pinned by in-flight requests:
                # retry after retirements free pins
                self._queue.appendleft(r)
                break
            except Exception as e:
                self._fail_or_requeue(r, e)
                continue
            i = next(j for j in free if self._lane_pod(j) == pod)
            free.remove(i)
            r.served_version = self.registry.current_version(r.variant)
            self._slots[i] = _Slot(request=r, variant_slot=vslot,
                                   remaining=r.max_new_tokens, vkey=vkey,
                                   pod=pod)
            self._variant_idx[i] = vslot
            self._vidx_dirty = True
            r.status = "running"
            newly.append(i)
            self.metrics["admitted"] += 1
        self._queue.extendleft(reversed(skipped))
        return newly

    def _pod_local(self, vidx: np.ndarray) -> np.ndarray:
        """The lanes' global slot ids as ids of the bank each lane's ranks
        hold: on a pod-local bank lane i of pod p carries global - p *
        bank_size (the ids themselves elsewhere).  A lane whose slot lies
        outside its pod's range raises here, on the host: the banked
        kernel traps on an id outside its bank, and that ends the CUDA
        context."""
        if self._pods == 1:
            return vidx
        size = self.registry.bank_size
        local = vidx.astype(np.int64) - self._lane_pods * size
        bad = np.flatnonzero((local < 0) | (local >= size))
        if bad.size:
            i = int(bad[0])
            p = int(self._lane_pods[i])
            raise ValueError(
                f"lane {i} (pod {p}) carries bank slot {int(vidx[i])}, "
                f"outside its pod's slots [{p * size}, {(p + 1) * size})")
        return local.astype(np.int32)

    def _fail_or_requeue(self, r: Request, e: Exception) -> None:
        """A failed admission: re-queue ``r`` at the back within its
        ``max_retries`` budget, else fail it."""
        r.retries += 1
        if r.retries > self.max_retries:
            r.status, r.error = "failed", str(e)
            self._done[r.rid] = r
            self.metrics["failed"] += 1
        else:
            r.status = "queued"
            self._queue.append(r)

    def _bank_tree(self):
        bank = self.registry.bank
        return bank.tree if bank is not None else None

    def _prefill_admitted(self, newly: list) -> None:
        """Prefill-on-admit: one fixed-shape (batch_size, prompt_len)
        prefill per admission wave, rows not admitted on the base slot;
        only the newly admitted rows of its cache and first tokens are
        merged into the persistent batch, in place (the first wave's
        too)."""
        pvidx = self._base_vidx.copy()
        for i in newly:
            pvidx[i] = self._slots[i].variant_slot
        batch = self._prompt_batch(
            {i: self._slots[i].request for i in newly})
        t0 = time.perf_counter()
        with self._ctx():
            last_logits, fresh = self.model.prefill(
                self.registry.base_params, batch,
                self.max_len, overlay=self._bank_tree(),
                variant_idx=self._local_rows(
                    torch.from_numpy(self._pod_local(pvidx)).to(
                        self.device)))
        first_tok = self._all_lanes(
            torch.argmax(last_logits, dim=-1).to(torch.int32))
        synchronize_stream(self.device)
        self.metrics["prefill_seconds"] += time.perf_counter() - t0
        self.metrics["prefills"] += 1
        idx = torch.tensor(newly, dtype=torch.int64, device=self.device)
        self._next_tok.index_copy_(0, idx, first_tok.index_select(0, idx))
        # this rank's cache holds its own lanes' rows
        self._merge_admitted(self._cache, fresh,
                             [i - self._lo for i in newly
                              if self._lo <= i < self._lo + self._nloc])

    def _retire(self, i: int) -> None:
        """Release lane ``i``: mark its request done, unpin the bank slot
        it decoded from, and free the lane for the next admission wave."""
        s = self._slots[i]
        s.request.status = "done"
        self._done[s.request.rid] = s.request
        self.registry.bank_unpin(s.vkey, s.pod)
        self._slots[i] = None
        self._variant_idx[i] = self._base_vidx[i]
        self._vidx_dirty = True
        self.metrics["retired"] += 1

    def _serve_lanes(self, max_rounds: int, advance,
                     max_steps: Optional[int] = None) -> None:
        """The slot scheduler's loop: commit at most one staged variant
        (async admission), free lanes admit queued requests
        (prefill-on-admit), every active lane appends its PENDING token (a
        prefill argmax, a decode step's or a round's; one host sync),
        exhausted lanes retire at once, then ``advance()`` moves the batch
        on: one decode step (continuous) or one speculative round.  With
        ``max_steps`` the loop returns after that many, lanes live."""
        # max_rounds bounds STALLED rounds (no admission, no token, no
        # failure), not decode steps: productive rounds are bounded by the
        # submitted token budgets
        stalls = steps = 0
        while (self._queue or self.active()) and stalls < max_rounds:
            if max_steps is not None and steps >= max_steps:
                break
            drained = 0
            if self.admission is not None:
                # the bounded on-thread cost of async admission: one
                # commit's slot writes, queued on the serving stream
                drained = self.admission.drain(max_admits=1)
                self.metrics["async_admits"] += drained
            failed0 = self.metrics["failed"]
            newly = self._admit_free_slots()
            if newly:
                self._prefill_admitted(newly)
            if not self.active():
                if not self._queue:
                    break
                # admissions failed this round: retry (a stall unless
                # requests were failed or a commit landed — retries
                # terminate)
                if self.metrics["failed"] > failed0 or drained:
                    stalls = 0
                elif self.admission is not None \
                        and self.admission.in_flight():
                    # every queued request is behind ingest and no lane
                    # decodes: sleep on the pipeline's progress
                    self.admission.wait_progress(0.05)
                    stalls = 0
                else:
                    stalls += 1
                continue
            stalls = 0
            host_tok = self._next_tok.cpu().numpy()
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                s.request.out_tokens.append(int(host_tok[i]))
                self._note_first_token(s.request)
                s.remaining -= 1
                self.metrics["tokens_generated"] += 1
                # retire at once: the lane is free for the next admission
                # wave instead of padding to the batch's largest budget
                if s.remaining <= 0:
                    self._retire(i)
            if not (self.active() or self._queue):
                break           # drained: skip the step nobody consumes
            if not self.active():
                continue        # lanes empty but queue pending: admit next
            if self._vidx_dirty:
                self._variant_idx_dev.copy_(
                    torch.from_numpy(self._pod_local(self._variant_idx)))
                self._vidx_dirty = False
            busy = drained > 0 or (self.admission is not None
                                   and self.admission.in_flight() > 0)
            t0 = time.perf_counter()
            advance()
            steps += 1
            if self.record_step_times:
                t1 = time.perf_counter()
                self.step_times.append((t1, t1 - t0, busy))
        self.metrics["batches"] += 1

    def _decode_step(self) -> None:
        """One banked decode step of the whole batch: each lane's next
        pending token."""
        t0 = time.perf_counter()
        bank = self._bank_tree()
        flavour = "banked" if bank is not None else "banked-empty"
        self._run_step((flavour, "decode_banked"),
                       self._decode_compute(bank), bank)
        synchronize_stream(self.device)
        self.metrics["decode_seconds"] += time.perf_counter() - t0
        self.metrics["decode_steps"] += 1

    def _spec_round(self) -> None:
        """One speculative round of the current draft length k: drafts on
        the base weights, one banked verify through each lane's slot.  Each
        lane appends its n_acc accepted drafts (within its budget; a lane
        that spends it retires, and its pending correction, past
        max_new_tokens, is dropped); the next pending token is the
        variant's correction."""
        _, bank = self.registry.spec_resolve()
        k = self.spec.current_k
        t0 = time.perf_counter()
        flavour = "spec" if bank is not None else "spec-empty"
        self._run_step((flavour, f"spec_k{k}"), self._round_compute(k, bank),
                       bank)
        ver, n_acc = self._spec_out[k]
        host_ver = ver.cpu().numpy()           # the round's host sync
        host_n = n_acc.cpu().numpy()
        self.metrics["decode_seconds"] += time.perf_counter() - t0
        self.metrics["decode_steps"] += 1
        self.metrics["spec_rounds"] += 1
        acc_total = lanes = 0
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            lanes += 1
            n = int(host_n[i])
            acc_total += n
            r = s.request
            r.drafted += k
            r.accepted += n
            take = min(n, s.remaining)
            r.out_tokens.extend(int(t) for t in host_ver[i, :take])
            self.metrics["tokens_generated"] += take
            s.remaining -= take
            if s.remaining <= 0:
                self._retire(i)
        self.metrics["spec_drafted"] += k * lanes
        self.metrics["spec_accepted"] += acc_total
        self.spec.observe(k, acc_total, lanes)

    # -- fixed-shape steps: eager or captured --------------------------------
    def _decode_compute(self, bank):
        """The continuous decode step as ``_run_step`` takes it: the
        banked decode of the pending tokens -> ([(live tensor, new value)],
        the new cache)."""
        def compute():
            with self._ctx():
                logits, cache = self.model.decode_step(
                    self.registry.base_params,
                    self._local_rows(self._next_tok),
                    _containers(self._cache), overlay=bank,
                    variant_idx=self._local_rows(self._variant_idx_dev))
            tok = self._all_lanes(
                torch.argmax(logits, dim=-1).to(torch.int32))
            return [(self._next_tok, tok)], cache
        return compute

    def _round_compute(self, k: int, bank):
        """The speculative round of draft length ``k`` as ``_run_step``
        takes it; its tokens and accept counts land in ``_spec_out[k]``.
        Under a mesh the round runs on the rank's lanes, and every lane's
        (k+1 verified tokens, accept count, next token) row is
        all-gathered in one collective, so every rank's scheduler and
        acceptance tracker see the same counts."""
        def compute():
            with self._ctx():
                ver, n_acc, next_tok, cache = self._rounds[k](
                    self.registry.base_params, bank,
                    self._local_rows(self._variant_idx_dev),
                    self._local_rows(self._next_tok),
                    _containers(self._cache))
            if self._lane_axes:
                rows = self._all_lanes(torch.cat(
                    [ver, n_acc[:, None], next_tok[:, None]], dim=1))
                ver, n_acc, next_tok = rows[:, :k + 1], rows[:, k + 1], \
                    rows[:, k + 2]
            ver_out, n_out = self._spec_out[k]
            return [(ver_out, ver), (n_out, n_acc),
                    (self._next_tok, next_tok)], cache
        return compute

    def _body(self, compute):
        """``compute()`` and its writes: each result into its live tensor,
        and every cache leaf the step rebound back into the live cache."""
        def body():
            outs, cache = compute()
            for live, new in outs:
                live.copy_(new)
            _copy_back(self._cache, cache)
        return body

    def _pointers(self, bank) -> tuple:
        """The addresses a captured step reads and writes: the base, the
        bank, the live cache and the live tensors."""
        return tuple(t.data_ptr() for t in tree_leaves(
            (self.registry.base_params, bank, self._cache, self._next_tok,
             self._variant_idx_dev, self._spec_out)))

    def _run_step(self, key: tuple, compute, bank) -> None:
        """One fixed-shape step of the slot scheduler: eagerly, or on a
        card as a replay of the graph held for ``key`` (flavour, kind),
        captured first when there is none or when the addresses it was
        captured on moved."""
        if not self.graphs:
            with torch.no_grad():
                self._body(compute)()
            return
        ptrs = self._pointers(bank)
        step = self._graphs.get(key)
        if step is None or step.pointers != ptrs:
            step = self._capture(key, compute, ptrs)
        step.replay()
        self.metrics["step_cache_hits"] += 1

    def _capture(self, key: tuple, compute, ptrs: tuple) -> CC.CapturedStep:
        """Capture the step of ``key`` (replacing a stale graph) into the
        engine's graph pool; a capture that fails raises."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs.pop(key, None)
        step = CC.CapturedStep(compute, self._body(compute), pool=self._pool,
                               pointers=ptrs)
        self._graphs[key] = step
        self.metrics["step_compiles"] += 1
        self.metrics["step_compile_seconds"] += step.seconds
        return step

    # -- warmup ------------------------------------------------------------------
    def register_warmup(self, name: str, builder) -> None:
        """Register (or replace) a warmup entry: ``builder(ctx)`` is called
        from ``warmup()`` with the shared context (``_warmup_ctx``) and
        warms its steps through ``ctx["eager"]`` and ``ctx["step"]``.  New
        step kinds join ``warmup()`` this way, as the speculative ladder
        does."""
        self._warmup_reg[name] = builder

    def warmup(self, pairs=None) -> dict:
        """Make every step ready BEFORE traffic (DESIGN.md §14): the
        entries of the warmup registry named in ``pairs`` (None: all) — by
        default the plain and fused pairs (base and single-variant
        prefill and decode), under the slot schedulers the banked pair
        (prefill and decode without and with the overlay bank, which is
        reserved here, and the admission merge), and under
        ``scheduler="speculative"`` one round per draft length of the
        ladder, without and with the bank.  The slot scheduler's decode
        steps and rounds are captured as CUDA graphs on a card; prefills,
        the merge and the group scheduler's steps run once eagerly.  The
        kernel library is built or loaded through the compile cache on
        the way.  Returns {entry/kind: "captured" | "hit" (a graph already
        held for these addresses) | "eager"}; the keys are the JAX
        engine's.  Under a mesh every rank runs the same entries in the
        same order (collectives run inside them), each model call in the
        mesh context on the rank's lanes, and every outcome is "eager"
        (graphs are off there)."""
        pairs = tuple(self._warmup_reg) if pairs is None else tuple(pairs)
        unknown = [p for p in pairs if p not in self._warmup_reg]
        if unknown:
            raise ValueError(
                f"unknown warmup pairs {unknown!r}; registered: "
                f"{sorted(self._warmup_reg)} (add new step kinds with "
                "register_warmup)")
        t0 = time.perf_counter()
        ctx = self._warmup_ctx()
        for name in pairs:
            self._warmup_reg[name](ctx)
        synchronize(self.device)
        self.metrics["warmup_seconds"] += time.perf_counter() - t0
        self.warmed = True
        return ctx["outcomes"]

    def _warmup_ctx(self) -> dict:
        """What the warmup builders share: the base, the target paths
        (``calibration.is_target``, the recipe ``compress`` follows), a
        fixed-shape prompt batch and slot vector (the rank's lanes, and
        their base slots as ids of the bank the rank holds), and two
        runners that record each outcome: ``eager(tag, kind, fn)`` runs
        ``fn`` once in the mesh context and returns its result;
        ``step(tag, kind, compute, bank)`` readies a slot-scheduler step
        without touching the live state (captured on a card, computed and
        dropped eagerly otherwise)."""
        from repro_torch.core.calibration import flatten_params, is_target

        base = self.registry.base_params
        outcomes: dict = {}

        def eager(tag, kind, fn):
            with torch.no_grad(), self._ctx():
                out = fn()
            outcomes[f"{tag}/{kind}"] = "eager"
            return out

        def step(tag, kind, compute, bank):
            key = (tag, kind)
            if not self.graphs:
                eager(tag, kind, compute)
                return
            ptrs = self._pointers(bank)
            held = self._graphs.get(key)
            if held is not None and held.pointers == ptrs:
                outcomes[f"{tag}/{kind}"] = "hit"
                return
            self._capture(key, compute, ptrs)
            outcomes[f"{tag}/{kind}"] = "captured"

        return {"base": base, "outcomes": outcomes, "eager": eager,
                "step": step,
                "delta_paths": sorted(
                    p for p, leaf in flatten_params(base).items()
                    if is_target(p, leaf)),
                "batch": self._prompt_batch({}),
                "vidx": self._local_rows(torch.from_numpy(
                    self._pod_local(self._base_vidx)).to(self.device))}

    def _warm_plain(self, ctx) -> None:
        eager, base, batch = ctx["eager"], ctx["base"], ctx["batch"]
        last, cache = eager("plain", "prefill", lambda: self.model.prefill(
            base, batch, self.max_len))
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        eager("plain", "decode",
              lambda: self.model.decode_step(base, tok, cache))

    def _warm_fused(self, ctx) -> None:
        """The single-variant pair over a zero overlay on every target
        (the shapes a fused resident has)."""
        from repro_torch.core.calibration import flatten_params
        from repro_torch.models import delta_overlay as DO

        if not ctx["delta_paths"]:
            return
        base_flat = flatten_params(ctx["base"])
        overlay: dict = {}
        for path in ctx["delta_paths"]:
            w = base_flat[path]
            lead, (n, k) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
            DO.insert_entry(overlay, path, DO.OverlayEntry(
                packed=torch.zeros(lead + (n, k // 8), dtype=torch.uint8,
                                   device=self.device),
                v_row=torch.zeros(lead + (n,), dtype=torch.float16,
                                  device=self.device),
                v_col=torch.zeros(lead + (k,), dtype=torch.float16,
                                  device=self.device)))
        eager, base = ctx["eager"], ctx["base"]
        last, cache = eager("fused", "prefill", lambda: self.model.prefill(
            base, ctx["batch"], self.max_len, overlay=overlay))
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        eager("fused", "decode", lambda: self.model.decode_step(
            base, tok, cache, overlay=overlay))

    def _warm_banked(self, ctx) -> None:
        """The slot scheduler's pair without a bank (before the first
        admit) and with it (reserved now: the tensors later admits write
        into), and the admission merge (of no row: the live state stays
        as it is)."""
        if not ctx["delta_paths"]:
            return
        eager, base = ctx["eager"], ctx["base"]
        bank = self.registry.reserve_bank()
        for tag, b in (("banked-empty", None), ("banked", bank)):
            _, fresh = eager(tag, "prefill_banked",
                             lambda b=b: self.model.prefill(
                                 base, ctx["batch"], self.max_len, overlay=b,
                                 variant_idx=ctx["vidx"]))
            ctx["step"](tag, "decode_banked", self._decode_compute(b), b)
        eager("banked", "merge",
              lambda: self._merge_admitted(self._cache, fresh, []))

    def _warm_speculative(self, ctx) -> None:
        """One round per rung of the ladder (each k is its own graph),
        without the bank and with it."""
        bank = self.registry.reserve_bank() if ctx["delta_paths"] else None
        for k in self.spec.ladder:
            ctx["step"]("spec-empty", f"spec_k{k}",
                        self._round_compute(k, None), None)
            if bank is not None:
                ctx["step"]("spec", f"spec_k{k}",
                            self._round_compute(k, bank), bank)

    # -- mesh: the context, the lanes' split ---------------------------------
    def _mesh_setup(self, batch_size: int) -> None:
        """The rule set, the layout of the registry's placed base and this
        rank's block of lanes (all of them off a mesh)."""
        self._nloc, self._lo, self._lane_axes = batch_size, 0, ()
        self._rules = self._layout = None
        if self.mesh is None:
            return
        from repro_torch.core.calibration import flatten_params
        from repro_torch.models.delta_overlay import flatten_axes
        reg, mesh = self.registry, self.mesh
        self._rules = SH.rules_for("decode", pod_banks=reg.pods > 1)
        self._layout = SH.Layout.from_placed(
            flatten_params(reg.base_params),
            flatten_axes(reg.param_shardings), flatten_axes(reg.param_axes),
            mesh, self._rules)
        part = SH.resolve_spec((batch_size,), ("act_batch",), self._rules,
                               mesh)[0]
        self._lane_axes = SH._names(part)
        if reg.pods > 1 and "pod" not in self._lane_axes:
            raise ValueError(
                f"batch_size={batch_size} must split over the mesh's pod "
                f"and data axes ({mesh.names_size(('pod', 'data'))} ranks) "
                "for pod-local banks: each rank decodes lanes of its own "
                "pod only")
        self._nloc = batch_size // mesh.names_size(self._lane_axes)
        self._lo = mesh.index(self._lane_axes) * self._nloc

    def _ctx(self):
        """The mesh context every model call and resolution runs in (and
        ``no_dispatch`` for ``kernel_dispatch="gspmd"``); nothing off a
        mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(SH.shard_ctx(self.mesh, self._rules,
                                         self._layout, self._lane_axes))
        if self.kernel_dispatch == "gspmd":
            from repro_torch.kernels import dispatch as D
            stack.enter_context(D.no_dispatch())
        return stack

    def _local_rows(self, x):
        """This rank's lanes of a (batch_size, ...) tensor or batch dict."""
        if not self._lane_axes:
            return x
        if isinstance(x, dict):
            return {k: self._local_rows(v) for k, v in x.items()}
        return x[self._lo:self._lo + self._nloc]

    def _all_lanes(self, tok: torch.Tensor) -> torch.Tensor:
        """Every lane's tokens from the ranks' blocks (all-gathered over the
        lanes' axes)."""
        if not self._lane_axes:
            return tok
        return SH.all_gather(tok, self._lane_axes, 0, self.mesh)

    def _prompt_batch(self, requests: dict) -> dict:
        """This rank's lanes of the fixed-shape (batch_size, prompt_len)
        prefill batch: row i holds requests[i]'s prompt tail,
        right-padded with zeros; unmapped rows stay zero; plus the
        frontend stub's inputs, built for the rank's lanes alone.  The one
        place prompt padding happens: both schedulers build identical
        batches."""
        toks = np.zeros((self.batch_size, self.prompt_len), np.int64)
        for i, r in requests.items():
            p = r.tokens[-self.prompt_len:]
            toks[i, :len(p)] = p
        batch = {"tokens": self._local_rows(
            torch.from_numpy(toks).to(self.device))}
        batch.update(frontend_stub(self.model.cfg, self._nloc, self.device))
        return batch


def _refuse_on_mesh(registry, *, scheduler: str, graphs: bool) -> None:
    """What mesh serving does not serve yet raises, naming its slice;
    nothing is switched off silently."""
    if registry.mesh is None:
        raise ValueError("a mesh engine needs a registry placed on the mesh "
                         "(VariantRegistry(mesh=, param_shardings=, "
                         "param_axes=))")
    if graphs and registry.device.type == "cuda" and scheduler != "group":
        raise NotImplementedError(
            "graphs=True under a mesh: a gloo collective cannot be "
            "captured in a CUDA graph; pass graphs=False (CUDA graphs under "
            "a mesh come with their own slice: NCCL, a card a rank)")


def _containers(tree):
    """``tree``'s dicts and lists copied, its tensors shared: a step may
    rebind entries of the copy (``cache["pos"] = pos + 1``) and leave the
    live structure pointing at the live tensors."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_containers(v) for v in tree)
    return tree


def _copy_back(live, new) -> None:
    """Write every leaf of ``new`` into the same-placed leaf of ``live``,
    skipping those that are the live tensor already (written in place by
    the step)."""
    if isinstance(live, dict):
        for key, leaf in live.items():
            _copy_back(leaf, new[key])
    elif isinstance(live, (list, tuple)):
        for leaf, n in zip(live, new, strict=True):
            _copy_back(leaf, n)
    elif new.shape != live.shape or new.dtype != live.dtype:
        raise ValueError(f"a step returned a {new.dtype} {tuple(new.shape)} "
                         f"leaf for a live {live.dtype} "
                         f"{tuple(live.shape)} one")
    elif not (new.data_ptr() == live.data_ptr()
              and new.stride() == live.stride()):
        live.copy_(new)


def frontend_stub(cfg, bs: int, device) -> dict:
    """The stubbed frontends' outputs for a batch of ``bs``, zeros in fp32
    as the JAX engine makes them: an audio model's encoder ``frames``
    (bs, encoder_frames, d), a VLM's ``image_embeds`` (bs, n_img, d);
    nothing for the text-only families."""
    if cfg.family == "audio":
        return {"frames": torch.zeros((bs, cfg.encoder_frames, cfg.d_model),
                                      device=device)}
    if cfg.family == "vlm":
        return {"image_embeds": torch.zeros(
            (bs, cfg.num_image_tokens, cfg.d_model), device=device)}
    return {}
