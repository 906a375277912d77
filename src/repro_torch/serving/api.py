"""Deployment: the versioned variant lifecycle as one control plane (port
of ``repro.serving.api``).

    dep = Deployment(model, base_params, root_dir="/srv/variants")
    v1  = dep.publish("support-bot", dm)          # full artifact, version 1
    rid = dep.submit(prompt, variant="support-bot")
    v2  = dep.update("support-bot", dm_next)      # XOR/RLE patch, hot-swap
    dep.drain()
    dep.status(rid)
    dep.rollback("support-bot")                   # pointer move

With a store (``root_dir=`` or ``store=``, a ``core/store.VariantStore``)
``publish`` writes a full artifact, ``update`` an incremental patch against
the current version, and ``rollback`` moves the store's pointer; the
registry holds lazy references and loads a version only when a request
needs it.  A second Deployment over the same directory hydrates each name's
lineage on first reference (``eager=True``: all at construction).  Without
a store, versions live in memory, as the JAX ``Deployment`` keeps them.

The deployment runs on ``device`` (default ``cuda``); the base params are
moved there.  ``scheduler="continuous"`` (the default) serves mixed-variant
batches from the overlay bank and needs ``mode="fused"``;
``speculative=True`` (or ``scheduler="speculative"``) decodes those lanes
by base-as-draft rounds of up to ``draft_k`` drafts, with the same tokens
(``serving/speculative.py``); ``scheduler="group"`` serves one variant per
batch, dense or fused.  ``base_dtype="int8"`` keeps the base's target
matrices as int8 plus fp16 per-channel scales (``core/quantize``).

Compile-once serving: ``warmup=True`` (or ``warmup()``) readies every step
before traffic, capturing the slot scheduler's decode steps and rounds as
CUDA graphs on a card (``serving/engine``); ``graphs=False`` runs them
eagerly.  ``compile_cache_dir`` installs a ``core/compile_cache``
directory of built kernel libraries as the process default (the library
loads once a process, at its first use), so a restart over the same
directory builds nothing.

Async admission (``async_admission=True``, the slot schedulers only;
``serving/admission``): ``publish``, ``update`` and ``rollback`` return
without loading anything and start ingest of the new current version on a
worker thread (the store read, patch chain and sha checks, then the copies
to the card on the worker's own stream, paced by ``admission_pacing_s``
between modules); the lanes keep decoding, and the version commits into
its bank slot between steps.  ``wait=True`` blocks until it is resident; a
request behind ingest reports ``admitting``; ``rollback`` of a variant
with a version mid-ingest raises.  ``max_retries`` bounds the retries of a
request whose variant fails to load, inline or on the pipeline.  ``close()``
stops the worker.

Mesh-sharded deployments (DESIGN.md §11): run one Deployment per rank —
``launch/mesh.spawn`` or ``torchrun`` — each with the same arguments, its
rank's ``mesh`` (``launch.mesh.make_host_mesh``) and ``param_axes`` (the
logical-axes tree from ``models.param.split``).  The whole base is placed
once (each rank keeps its blocks, ``distributed/sharding.place``) and
every variant inherits the placement; the delta kernels run per rank
(``kernel_dispatch="shard_map"``, or ``"gspmd"``: gathered global kernels,
the A/B reference).  With ``base_dtype="int8"`` each rank quantizes its
blocks to the single-device bytes and the kernels run their int8 bodies
on the rank's tiles.  Every rank returns the same tokens.  Async admission
serves on a mesh too: the ranks agree on each commit
(``serving/admission``).  So do ``speculative=True`` (every rank drafts
and verifies its lanes, and the ranks gather each round's results, so
their ladders walk in step) and ``warmup=True`` (every entry on every
rank, each outcome "eager").  ``pod_banks=True`` on a (pod, data, model)
mesh keeps one bank per pod (``bank_size`` slots each) and routes each
request to a pod that holds its variant (``serving/engine``); it serves
every family with the continuous scheduler, MoE included, and refuses
``speculative``, as JAX does.  One refusal is left under a mesh:
``graphs=True`` on a card (a gloo collective cannot be captured in a CUDA
graph; CUDA graphs under a mesh come with their own slice: NCCL, a card
a rank).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import compile_cache as CC
from repro_torch.core import store as S
from repro_torch.core.calibration import DeltaModel
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.variants import VariantRegistry
from repro_torch.tree import tree_map


class Deployment:
    """One resident base model, a store (or in-memory lineages) of variant
    versions and a serving engine behind
    publish/update/rollback/submit/drain/status."""

    def __init__(self, model, base_params, *, root_dir=None,
                 store: Optional[S.VariantStore] = None, mode: str = "fused",
                 scheduler: str = "continuous", batch_size: int = 4,
                 prompt_len: int = 32, max_len: int = 128,
                 bank_size: int = 8, max_resident: int = 8,
                 eager: bool = False, device=None, base_dtype: str = "fp",
                 speculative: bool = False, draft_k: int = 4,
                 warmup: bool = False, compile_cache_dir=None,
                 graphs: bool = True, max_retries: int = 1,
                 async_admission: bool = False,
                 admission_pacing_s: float = 0.002, mesh=None,
                 param_axes=None, param_shardings=None,
                 kernel_dispatch: str = "shard_map",
                 pod_banks: bool = False):
        if store is not None and root_dir is not None:
            raise ValueError("pass either store or root_dir, not both")
        if base_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown base dtype {base_dtype!r}")
        if pod_banks and (speculative or scheduler == "speculative"):
            raise ValueError(
                "pod_banks=True does not compose with the speculative "
                "scheduler (its verify rounds have no per-pod slot "
                "translation); use scheduler='continuous'")
        if speculative:
            if scheduler not in ("continuous", "speculative"):
                raise ValueError(
                    "speculative=True layers on the continuous slot "
                    "scheduler; drop scheduler='group'")
            scheduler = "speculative"
        if scheduler in ("continuous", "speculative") and mode != "fused":
            # the continuous scheduler admits through the overlay bank,
            # which is fused-only: accepting mode="dense" here would
            # silently serve fused residents
            raise ValueError(
                f"scheduler={scheduler!r} requires mode='fused' (mixed "
                "batches serve from the packed overlay bank); use "
                "scheduler='group' for dense residency")
        self.device = resolve_device(device)
        # the kernel library's build cache: process-wide, like the library
        self.compile_cache = None
        if compile_cache_dir is not None:
            self.compile_cache = CC.CompileCache(compile_cache_dir)
            CC.set_default(self.compile_cache)
        base_fp = None
        if mesh is not None:
            if param_axes is None:
                raise ValueError(
                    "a sharded deployment needs param_axes (the logical "
                    "axes tree from models.param.split) with the mesh")
            if param_shardings is None:
                param_shardings = SH.tree_pspecs(
                    base_params, param_axes, SH.rules_for("decode"), mesh)
            # artifacts are fingerprinted against the whole base; then the
            # base is placed once: each rank keeps its blocks
            base_fp = S.base_fingerprint(base_params)
            base_params = SH.place(base_params, param_shardings, mesh,
                                   device=self.device)
        else:
            base_params = tree_map(lambda t: t.to(self.device), base_params)
        self.model = model
        self.mesh = mesh
        # the registry fingerprints the fp base, then quantizes it (on a
        # mesh: each rank its placed blocks, to the single-device bytes)
        self.registry = VariantRegistry(base_params,
                                        max_resident=max_resident, mode=mode,
                                        bank_size=bank_size,
                                        base_dtype=base_dtype, mesh=mesh,
                                        param_shardings=param_shardings,
                                        param_axes=param_axes,
                                        base_fp=base_fp, pod_banks=pod_banks)
        if store is None and root_dir is not None:
            store = S.VariantStore(root_dir, base_fp=self.registry.base_fp)
        if store is not None and store.base_fp is None:
            store.base_fp = self.registry.base_fp
        if store is not None and mesh is not None \
                and store.param_shardings is None:
            # the store's loads then return each rank's blocks, and only
            # rank 0 writes the directory (the registry's specs: an int8
            # base's QuantWeight placements)
            store.param_shardings = self.registry.param_shardings
            store.mesh = mesh
        self.store = store
        # restart hydration is lazy by default: a store-backed node
        # registers a name's lineage on its first reference (admission, an
        # explicit name@vN, rollback) through the registry's hydrator hook
        self._hydrated: set = set()
        if store is not None:
            if eager:
                for name in store.names():
                    self._hydrate(name)
            else:
                self.registry.hydrator = self._hydrate
        self.admission = None
        if async_admission:
            if scheduler not in ("continuous", "speculative"):
                raise ValueError(
                    "async_admission requires the continuous slot "
                    "scheduler (staged overlays commit into the overlay "
                    "bank between decode steps)")
            from repro_torch.serving.admission import AdmissionPipeline
            self.admission = AdmissionPipeline(
                self.registry, pacing_s=admission_pacing_s)
            self.registry.admission = self.admission
        self.engine = ServingEngine(model, self.registry,
                                    batch_size=batch_size,
                                    prompt_len=prompt_len, max_len=max_len,
                                    max_retries=max_retries,
                                    scheduler=scheduler, draft_k=draft_k,
                                    graphs=graphs, admission=self.admission,
                                    mesh=mesh,
                                    kernel_dispatch=kernel_dispatch)
        if warmup:
            # every step ready before traffic: captured on a card, and the
            # kernel library built or loaded through the compile cache
            self.engine.warmup()

    def _hydrate(self, name: str) -> bool:
        """Register every persisted version of ``name`` from the store
        (idempotent per name; False when the store does not know it)."""
        if self.store is None or name in self._hydrated:
            return False
        try:
            versions = self.store.versions(name)
        except (KeyError, IOError):
            return False
        self._hydrated.add(name)
        for v in versions:
            self.registry.set_version(name, v, self._store_ref(name, v))
        self.registry.set_version(name, self.store.latest(name))
        return True

    def _store_ref(self, name: str, version: int):
        """Lazy materialisation: the registry loads (and the store caches)
        the version only when a request needs it.  The reference
        advertises ``accepts_pacer``, so the admission worker's pacing
        reaches the streamed read."""
        store = self.store

        def ref(pacer=None):
            return store.load(name, version, pacer=pacer)
        ref.accepts_pacer = True
        return ref

    # -- control plane -----------------------------------------------------
    def publish(self, name: str, dm: DeltaModel, *,
                mode: Optional[str] = None, meta: Optional[dict] = None,
                wait: bool = False) -> int:
        """Publish ``dm`` as the next full version of ``name`` (a full
        artifact, ``meta`` in its manifest, when a store backs this
        deployment) and point serving at it; ``wait=True`` makes it
        resident now.  Under async admission the call does not block:
        ingest starts on the pipeline.  Returns the version."""
        if mode == "dense" and self.engine.scheduler in ("continuous",
                                                         "speculative"):
            raise ValueError(
                "per-variant mode='dense' cannot serve under the "
                "continuous scheduler (overlay-bank admission is "
                "fused-only)")
        if self.store is not None:
            v = self.store.publish(name, dm, meta=meta)
            artifact = self._store_ref(name, v)
        else:
            v = self.registry.next_version(name)
            artifact = dm
        self.registry.set_version(name, v, artifact, mode=mode)
        self._after_swap(name, wait)
        return v

    def update(self, name: str, dm: DeltaModel, *,
               meta: Optional[dict] = None, wait: bool = False) -> int:
        """Next version of an existing variant + atomic pointer move; with
        a store it ships as an XOR/RLE patch against the current version.
        In-flight requests finish on the version they pinned; under async
        admission the patch chain runs on the pipeline."""
        if self.store is not None:
            v = self.store.publish_update(name, dm, meta=meta)
            artifact = self._store_ref(name, v)
        else:
            if not self.registry.has_variant(name):
                raise KeyError(f"unknown variant {name!r}; publish first")
            v = self.registry.next_version(name)
            artifact = dm
        self.registry.set_version(name, v, artifact)
        self._after_swap(name, wait)
        return v

    def rollback(self, name: str, to_version: Optional[int] = None, *,
                 wait: bool = False) -> int:
        """Pointer move back to ``to_version`` (default: previous); with a
        store, the store's pointer moves and no artifact is touched.
        Raises while a version of ``name`` is mid-ingest on the admission
        pipeline (the rollback would race its commit)."""
        if self.admission is not None and self.admission.staging(name):
            raise RuntimeError(
                f"variant {name!r} has a version mid-admission; wait for "
                "it to land before rolling back")
        if self.store is not None:
            v = self.store.rollback(name, to_version)
            # the registry may not know this version yet (a fresh
            # Deployment over an existing store directory)
            self.registry.set_version(name, v, self._store_ref(name, v))
        else:
            v = self.registry.rollback(name, to_version)
        self._after_swap(name, wait)
        return v

    def _after_swap(self, name: str, wait: bool) -> None:
        """After a pointer move: an async deployment starts ingest of the
        new current version now (``wait=True``: and blocks until it is
        resident); otherwise ``wait=True`` makes it resident inline: a
        bank slot under the slot schedulers, a dense or fused resident
        under the group scheduler."""
        if self.admission is not None:
            self.admission.prefetch(name)
            if wait:
                self.admission.wait(name)
            return
        if not wait:
            return
        with self.engine._ctx():
            if self.engine.scheduler in ("continuous", "speculative"):
                self.registry.bank_resolve(name)
            else:
                self.registry.resolve(name)

    def warmup(self) -> dict:
        """Ready every step for this deployment's shapes now (as
        ``warmup=True`` does); returns each entry's outcome ("captured" |
        "hit" | "eager")."""
        return self.engine.warmup()

    def current(self, name: str) -> Optional[int]:
        return self.registry.current_version(name)

    def versions(self, name: str) -> list:
        return (self.store.versions(name) if self.store is not None
                else self.registry.versions(name))

    def variants(self) -> list:
        """Servable variant names.  Under lazy hydration the registry only
        knows referenced names; the store's listing fills in the rest."""
        names = set(self.registry.registered())
        if self.store is not None:
            names.update(self.store.names())
        return ["__base__"] + sorted(names - {"__base__"})

    def admitting(self) -> list:
        """Version keys mid-ingest on the admission pipeline (empty for a
        synchronous deployment)."""
        return [] if self.admission is None else self.admission.admitting()

    def close(self) -> None:
        """Stop the admission worker (idempotent; nothing runs in the
        background of a synchronous deployment)."""
        if self.admission is not None:
            self.admission.close()

    # -- data plane --------------------------------------------------------
    def submit(self, tokens, variant: str = "__base__",
               max_new_tokens: int = 16) -> int:
        return self.engine.submit(tokens, variant=variant,
                                  max_new_tokens=max_new_tokens)

    def drain(self, max_rounds: int = 1000,
              max_steps: Optional[int] = None) -> dict:
        """Serve until the queue and every lane are empty (``max_steps``:
        return after that many decode steps, lanes live); returns the
        engine metrics."""
        return self.engine.run_until_drained(max_rounds, max_steps)

    def result(self, rid: int) -> Request:
        return self.engine.result(rid)

    def status(self, rid: Optional[int] = None) -> dict:
        """With ``rid``: one request's lifecycle view (never raises; a
        speculative lane adds its ``acceptance``, the share of the drafts
        offered to it that it accepted); without: the engine snapshot."""
        if rid is None:
            return self.engine.status()
        r = self.engine.request(rid)
        if r is None:
            return {"status": "unknown", "rid": rid}
        out = {"status": r.status, "rid": rid, "variant": r.variant,
               "version": r.served_version,
               "tokens_generated": len(r.out_tokens),
               "first_token_at": r.first_token_at,
               "ttft_seconds": (None if r.first_token_at is None
                                else r.first_token_at - r.submitted_at),
               "error": r.error}
        if r.drafted:
            out["acceptance"] = r.accepted / r.drafted
        return out

    def pending(self) -> int:
        """Requests queued and not yet in a lane."""
        return self.engine.pending()

    def active(self) -> int:
        """Lanes serving a request now."""
        return self.engine.active()

    @property
    def metrics(self) -> dict:
        return self.engine.metrics

    @property
    def stats(self) -> dict:
        """Registry swap/residency counters (hits, swaps, resident bytes)."""
        return self.registry.stats
