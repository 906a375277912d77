"""Async admission pipeline (port of ``repro.serving.admission``): artifact
ingest off the serving thread.

The synchronous path admits a variant inline: the first request for a new
version pays the store read, the patch chain, the sha checks, the
host-to-device copies and the bank writes on the serving thread, and every
decoding lane waits.  Here a second timeline runs beside the lanes
(DESIGN.md §13):

1. **ingest** (worker thread): ``registry._load(pacer=)`` -> the store's
   chunked per-module read, patch chain and sha checks, all on the host;
   the worker sleeps ``pacing_s`` between modules, so the serving thread
   keeps the interpreter between its steps;
2. **stage** (worker thread): ``loader.stage_overlay_transfer`` queues the
   copies to the device on the worker's own CUDA stream, through pinned
   buffers of ``pool`` (``core/store.StagingPool``), one event per module;
3. **commit** (serving thread, between steps): the engine's
   ``drain(max_admits=1)`` writes one staged variant into its bank slot
   (``VariantRegistry._bank_admit(block=False)``): the writes wait on the
   staging events on the serving stream and land in the bank's own
   tensors, so the next graph replay reads them in place, after them.

Tickets move ``queued -> staging -> staged -> admitted | failed``.  A
failed ticket is consumed by the first ``poll`` that sees it (the caller
re-queues the request within its own ``max_retries`` budget).  While a
ticket lives its version key is marked ``staging`` on the overlay bank, so
``evict`` and ``Deployment.rollback`` of a version mid-ingest raise
instead of racing the commit.

Threads: one daemon ingest worker (started on the first prefetch) and the
serving thread.  The worker touches the store (under its lock), the
registry's version tables (read only), the pool and its own stream; every
bank write happens on the serving thread, in ``drain`` or ``wait``.

Tickets are keyed per (version key, pod): a pod-local bank admits one
version into two pods as two ingests, each bound for its pod's slots
(DESIGN.md §17).  Off pod-local banks every ticket is pod 0's.

On a mesh every rank runs this pipeline over the same calls, but each
rank's worker finishes at its own time, and a rank that committed a ticket
a step before another would part from it (slot tables, ``variant_idx``,
the batches decoded).  So the ranks agree (``_agree``): each ``drain``
with tickets live makes one MIN all-reduce over the host group of every
live ticket's progress, in ticket-creation order (the same order on every
rank: tickets are made and dropped only on the serving thread, by the same
calls).  A ticket commits on every rank in the same drain or on none;
a failure on any rank fails it on every rank (its error gathered from the
rank that failed); ``poll``, ``in_flight``, ``staging`` and ``wait`` answer
from the agreed progress.  A rank outside a ticket's pod stages nothing
and counts as staged at once.  With no ticket live there is no collective.
The JAX pipeline runs under one controller and needs no agreement.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import threading
import time
import weakref
from typing import Optional

import torch

from repro_torch.core import loader as L
from repro_torch.core import store as S


@dataclasses.dataclass
class AdmissionTicket:
    """One variant version moving through the ingest pipeline, bound for
    one pod's slots."""
    nameish: str                      # caller-facing request string
    name: str
    version: object                   # None for unversioned registrations
    vkey: str                         # bank key (name@vN)
    pod: int = 0                      # the pod whose slots it fills
    state: str = "queued"             # queued|staging|staged|admitted|failed
    agreed: str = "queued"            # the progress every rank has reached
    error: Optional[str] = None
    dm: object = None                 # the staged DeltaModel (device)
    futures: list = dataclasses.field(default_factory=list)  # Transfers
    enqueued_at: float = 0.0
    staged_at: float = 0.0


_LIVE = ("queued", "staging", "staged")
# progress levels for the mesh agreement: the MIN over the ranks is the
# least advanced rank's state (a failure anywhere wins)
_LEVELS = ("failed", "queued", "staging", "staged")


class AdmissionPipeline:
    """Background ingest and staging, and a between-step commit, for
    overlay-bank admission.

    ``prefetch`` enqueues ingest of a variant's current version
    (publish/update call it, so staging overlaps the traffic still
    decoding); ``poll`` reports progress (prefetching a variant it has not
    seen: the engine's admission loop is the other entry point); ``drain``
    commits staged variants into the bank, at most ``max_admits`` per
    call, which bounds the serving thread's work per step; ``wait`` blocks
    until a variant (or everything) has settled, the ``wait=`` escape
    hatch of the control-plane verbs."""

    def __init__(self, registry, *, pacing_s: float = 0.002):
        self.registry = registry
        # the worker sleeps pacing_s between module streams, so no single
        # decode step absorbs the whole ingest where ingest and the serving
        # thread share the interpreter and cores; 0 disables
        self.pacing_s = pacing_s
        self.device = registry.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pool = S.StagingPool(pin_memory=self.device.type == "cuda")
        self._cond = threading.Condition()
        self.mesh = registry.mesh
        # (vkey, pod) -> ticket, in creation order
        self._tickets: dict[tuple, AdmissionTicket] = {}
        self._work: collections.deque = collections.deque()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.stats = {"prefetches": 0, "staged": 0, "commits": 0,
                      "failures": 0, "stage_seconds": 0.0}

    # -- enqueue -----------------------------------------------------------
    def prefetch(self, nameish: str, pod: int = 0) -> Optional[str]:
        """Begin ingest of ``nameish``'s current version (or an explicit
        ``name@vN``) toward ``pod``'s slots.  Idempotent: a version
        resident in that pod or a live ticket returns at once.  Returns the
        version key (None for the base, which needs no admission)."""
        if nameish == "__base__":
            return None
        name, version = self.registry._parse(nameish)   # KeyError: unknown
        vkey = self.registry._vkey(name, version)
        bank = self.registry.bank
        if bank is not None and bank.holds(vkey, pod):
            return vkey                                  # already admitted
        with self._cond:
            if self._closed:
                raise RuntimeError("admission pipeline is closed")
            t = self._tickets.get((vkey, pod))
            if t is not None and self._view(t) in _LIVE:
                return vkey
            t = AdmissionTicket(nameish=nameish, name=name, version=version,
                                vkey=vkey, pod=pod,
                                enqueued_at=time.perf_counter())
            self._tickets.pop((vkey, pod), None)
            self._tickets[(vkey, pod)] = t
            # marked before the worker can see the ticket: evict and
            # rollback refuse from the moment ingest is promised
            bank = self.registry._ensure_bank()
            bank.mark_staging(vkey, pod)
            self.stats["prefetches"] += 1
            if bank.writes(pod):
                self._work.append(t)
                self._ensure_worker()
            else:
                # a rank outside the pod stages nothing
                t.state = "staged"
            self._cond.notify_all()
        return vkey

    def _view(self, t: AdmissionTicket) -> str:
        """A ticket's state as the caller may act on it: the agreed one on
        a mesh, this rank's own off it."""
        return t.agreed if self.mesh is not None else t.state

    # -- progress ----------------------------------------------------------
    def poll(self, nameish: str, pod: int = 0) -> str:
        """``admitted`` once the version is resident in ``pod``, else the
        live ticket's state (prefetching a variant never seen).  A failed
        ticket is consumed here, so a later poll ingests again, and its
        error re-raised for the caller's retry budget."""
        name, version = self.registry._parse(nameish)
        vkey = self.registry._vkey(name, version)
        bank = self.registry.bank
        if bank is not None and bank.holds(vkey, pod):
            return "admitted"
        with self._cond:
            t = self._tickets.get((vkey, pod))
            if t is not None and self._view(t) == "failed":
                del self._tickets[(vkey, pod)]
                raise RuntimeError(t.error)
        if t is None:
            self.prefetch(nameish, pod)
            return "queued"
        return self._view(t)

    def staging(self, name: str) -> bool:
        """A version of ``name`` is mid-pipeline (queued, staging or
        staged).  The rollback guard."""
        with self._cond:
            return any(t.name == name and self._view(t) in _LIVE
                       for t in self._tickets.values())

    def admitting(self) -> list:
        """Version keys mid-pipeline (a key bound for several pods appears
        once)."""
        with self._cond:
            return sorted({t.vkey for t in self._tickets.values()
                           if self._view(t) in _LIVE})

    def in_flight(self) -> int:
        with self._cond:
            return sum(1 for t in self._tickets.values()
                       if self._view(t) in _LIVE)

    def wait_progress(self, timeout: float) -> None:
        """Block the serving thread until a ticket can commit (or has
        failed), at most ``timeout`` seconds: the engine's idle wait when
        every queued request is behind ingest."""
        with self._cond:
            if any(t.state in ("staged", "failed")
                   for t in self._tickets.values()):
                return
            self._cond.wait(timeout)

    # -- commit (serving thread) -------------------------------------------
    def drain(self, max_admits: int = 1) -> int:
        """Commit up to ``max_admits`` staged variants into the bank (slot
        writes queued on the serving stream, no host fence), in ticket
        order; on a mesh after the ranks agree (``_agree``).  The engine
        calls it between steps with ``max_admits=1``.  Returns the number
        of commits."""
        self._agree()
        return self._commit_ready(max_admits)

    def _commit_ready(self, max_admits: int) -> int:
        done = 0
        while done < max_admits:
            with self._cond:
                t = next((t for t in self._tickets.values()
                          if self._view(t) == "staged"), None)
            if t is None or not self._commit(t):
                break
            done += 1
        return done

    def _agree(self, expired: bool = False) -> bool:
        """On a mesh, with tickets live: one MIN all-reduce over the host
        group of each ticket's progress (``_LEVELS``; in creation order),
        plus ``expired`` (a deadline passed on this rank), so every rank
        takes the same ticket states.  A ticket failed on some rank fails
        here on every rank, with the error the first failing rank reports
        (gathered: one more collective, on every rank alike).  Returns
        whether any rank's deadline passed."""
        if self.mesh is None:
            return expired
        with self._cond:
            tickets = [t for t in self._tickets.values()
                       if t.agreed != "failed"]
            levels = [_LEVELS.index(t.state if t.state in _LEVELS
                                    else "failed") for t in tickets]
        if not tickets:
            return expired
        got = self.mesh.agree_min(levels + [0 if expired else 1])
        failed = [t for t, lv in zip(tickets, got) if _LEVELS[lv] == "failed"]
        errors = None
        if failed:
            with self._cond:
                mine = [t.error if t.state == "failed" else None
                        for t in failed]
            errors = self.mesh.gather(mine)
        with self._cond:
            for i, (t, lv) in enumerate(zip(tickets, got)):
                t.agreed = _LEVELS[lv]
                if t.agreed != "failed":
                    continue
                j = failed.index(t)
                t.error = next(e[j] for e in errors if e[j] is not None)
                if t.state != "failed":
                    # failed elsewhere: this rank drops its staged copy
                    t.state = "failed"
                    t.dm, t.futures = None, []
                    self.stats["failures"] += 1
                self.registry._ensure_bank().unmark_staging(t.vkey, t.pod)
            self._cond.notify_all()
        return got[-1] == 0

    def _commit(self, t: AdmissionTicket) -> bool:
        """One staged ticket -> its bank slot.  RuntimeError (the pod's
        slots are full, every one pinned) leaves the ticket staged for a
        later drain; any other failure fails the ticket."""
        try:
            self.registry._bank_admit(t.vkey, t.dm, block=False,
                                      transfers=t.futures, pod=t.pod)
        except RuntimeError:
            return False          # capacity pressure: retry later
        except Exception as e:  # noqa: BLE001 — the ticket carries it
            with self._cond:
                t.state, t.error = "failed", str(e)
                t.agreed = "failed"
                t.dm, t.futures = None, []
                self.registry._ensure_bank().unmark_staging(t.vkey, t.pod)
                self.stats["failures"] += 1
                self._cond.notify_all()
            return False
        with self._cond:
            t.state = "admitted"
            # residency now shows in the bank itself (poll checks it first)
            del self._tickets[(t.vkey, t.pod)]
            self.registry.bank.unmark_staging(t.vkey, t.pod)
            self.stats["commits"] += 1
            self._cond.notify_all()
        return True

    def wait(self, nameish: Optional[str] = None, *,
             timeout: float = 30.0) -> None:
        """Block until ``nameish`` (or, with None, every live ticket) has
        been committed or has failed, committing staged tickets on this
        thread, so waiting works with or without the engine's drain loop.
        Raises a failed ticket's error; TimeoutError past the deadline."""
        vkey = None
        if nameish is not None and nameish != "__base__":
            name, version = self.registry._parse(nameish)
            vkey = self.registry._vkey(name, version)
        deadline = time.monotonic() + timeout
        while True:
            # on a mesh the deadline is agreed too: every rank raises alike
            expired = self._agree(time.monotonic() > deadline)
            self._commit_ready(1 << 30)
            with self._cond:
                live = [t for t in self._tickets.values()
                        if vkey is None or t.vkey == vkey]
                failed = next((t for t in live
                               if self._view(t) == "failed"), None)
                if failed is not None:
                    del self._tickets[(failed.vkey, failed.pod)]
                    raise RuntimeError(failed.error)
                if not live:
                    return                      # committed (or never live)
                if expired:
                    raise TimeoutError(
                        f"admission of {nameish or 'all variants'} did not "
                        f"settle within {timeout:.1f}s")
                self._cond.wait(min(max(deadline - time.monotonic(), 0.0),
                                    0.05))

    def close(self) -> None:
        """Stop the ingest worker (idempotent).  Live tickets stay
        uncommitted; the thread exits at its next wakeup."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30.0)
            self._worker = None

    # -- ingest worker -----------------------------------------------------
    def _pace(self) -> None:
        """Yield the host between module streams (see ``pacing_s``)."""
        if self.pacing_s > 0:
            time.sleep(self.pacing_s)

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            if self._worker is None:
                # stop the worker before the interpreter tears torch down
                # under it, if the owner never closed the pipeline
                atexit.register(_close_at_exit, weakref.ref(self))
            self._worker = threading.Thread(
                target=self._run, name="admission-ingest", daemon=True)
            self._worker.start()

    def _run(self) -> None:
        stream = None
        if self.device.type == "cuda":
            # the worker's own device context and stream: its copies never
            # queue behind (or ahead of) the serving stream's steps
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        while True:
            with self._cond:
                while not self._work and not self._closed:
                    self._cond.wait(1.0)
                if self._closed:
                    return
                t = self._work.popleft()
                if t.state != "queued":
                    continue
                t.state = "staging"
            try:
                t0 = time.perf_counter()
                dm = self.registry._load(t.name, t.version, pacer=self._pace)
                # a structure the bank refuses fails here, before the
                # ranks agree, never at a commit on one rank alone
                self.registry._ensure_bank().check(dm)
                dm_dev, futures = L.stage_overlay_transfer(
                    dm, device=self.device, stream=stream, pool=self.pool)
                with self._cond:
                    if t.state == "staging":    # not failed by the agreement
                        t.dm, t.futures = dm_dev, futures
                        t.state, t.staged_at = "staged", time.perf_counter()
                        self.stats["staged"] += 1
                        self.stats["stage_seconds"] += t.staged_at - t0
                    self._cond.notify_all()
            except Exception as e:  # noqa: BLE001 — the ticket carries it
                with self._cond:
                    if t.state == "staging":
                        t.state, t.error = "failed", str(e)
                        self.stats["failures"] += 1
                        if self.mesh is None:
                            # on a mesh the mark goes when the ranks agree
                            self.registry.bank.unmark_staging(t.vkey, t.pod)
                    self._cond.notify_all()


def _close_at_exit(ref) -> None:
    pipeline = ref()
    if pipeline is not None:
        pipeline.close()
