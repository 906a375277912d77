"""Serving engine (port of ``repro.serving.engine`` without mesh, pods,
async admission and warmup).  Three schedulers:

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

PyTorch runs eagerly, so there is no step compilation or warmup.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.serving.variants import VariantRegistry
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt (prompt_len,)
    variant: str = "__base__"
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    status: str = "queued"        # queued | running | done | failed
    retries: int = 0
    error: Optional[str] = None
    served_version: Optional[int] = None   # version resolved at admission
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


class ServingEngine:
    """Fixed-shape batched serving: ``batch_size`` lanes, prompts padded to
    ``prompt_len``, KV capacity ``max_len``.  ``scheduler`` is
    "continuous" (mixed-variant lanes over the overlay bank),
    "speculative" (the same lanes, decoded by base-as-draft rounds of up
    to ``draft_k`` drafts) or "group" (grouped by variant — required for
    dense residency)."""

    def __init__(self, model, registry: VariantRegistry, *,
                 batch_size: int = 4, prompt_len: int = 32,
                 max_len: int = 128, max_retries: int = 1,
                 scheduler: str = "group", draft_k: int = 4,
                 spec_adaptive: bool = True):
        if scheduler not in ("group", "continuous", "speculative"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
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
        self.device = tree_leaves(registry.base_params)[0].device
        self._queue: collections.deque[Request] = collections.deque()
        self._done: dict[int, Request] = {}
        self._next_rid = 0
        # continuous-scheduler state (persists across run_until_drained
        # calls: the decode batch is a long-lived object)
        self._slots: list[Optional[_Slot]] = [None] * batch_size
        self._cache = None
        self._next_tok = None
        # per-lane bank slot; idle lanes sit on slot 0 (the base)
        self._variant_idx = np.zeros(batch_size, np.int32)
        self._variant_idx_dev = None     # device copy, rebuilt on change
        # speculative rounds: one round function per draft length of the
        # adaptive ladder
        self.spec = None
        self._rounds = {}
        if scheduler == "speculative":
            from repro_torch.serving import speculative as SPEC
            self.spec = SPEC.AcceptanceTracker(draft_k,
                                               adaptive=spec_adaptive)
            self._rounds = {k: SPEC.make_round_fn(model, k)
                            for k in self.spec.ladder}
        self.metrics = {"batches": 0, "tokens_generated": 0, "prefills": 0,
                        "failed": 0, "admitted": 0, "retired": 0,
                        "decode_steps": 0,
                        "prefill_seconds": 0.0, "decode_seconds": 0.0,
                        "spec_rounds": 0, "spec_drafted": 0,
                        "spec_accepted": 0,
                        "ttft_count": 0, "ttft_seconds_sum": 0.0,
                        "ttft_seconds_max": 0.0}

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
        self.metrics["ttft_count"] += 1
        self.metrics["ttft_seconds_sum"] += ttft
        self.metrics["ttft_seconds_max"] = max(
            self.metrics["ttft_seconds_max"], ttft)

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
                "ttft": {"count": n,
                         "mean_seconds": (self.metrics["ttft_seconds_sum"]
                                          / n if n else 0.0),
                         "max_seconds": self.metrics["ttft_seconds_max"]},
                "metrics": dict(self.metrics),
                # resident device memory: the base weights (int8 cuts the
                # targets to about a quarter of fp32) next to the bank
                "hbm": {"base_dtype": reg.base_dtype,
                        "base_bytes": reg.base_nbytes(),
                        "base_per_device": reg.base_per_device_nbytes(),
                        "bank_bytes": bank.nbytes() if bank is not None
                        else 0}}
        if self.spec is not None:
            snap["speculative"] = self.spec.snapshot()
        return snap

    def pending(self) -> int:
        return len(self._queue)

    def active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def run_until_drained(self, max_rounds: int = 1000) -> dict:
        if self.scheduler == "continuous":
            self._serve_lanes(max_rounds, self._decode_step)
            return self.metrics
        if self.scheduler == "speculative":
            self._serve_lanes(max_rounds, self._spec_round)
            return self.metrics
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
        last_logits, cache = self.model.prefill(params, batch, self.max_len,
                                                overlay=overlay)
        # greedy over the padded vocab, as the JAX engine does
        next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
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
            logits, cache = self.model.decode_step(params, next_tok, cache,
                                                   overlay=overlay)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
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

    def _admit_free_slots(self) -> list:
        """Pop queued requests into free lanes: resolve each request's
        variant to a bank slot (admitting it on a miss) and pin it for the
        request's lifetime.  Unknown variants re-queue up to max_retries
        then fail; a fully pinned bank re-queues the head and waits for
        retirements."""
        newly: list = []
        free = [i for i in range(self.batch_size) if self._slots[i] is None]
        while free and self._queue:
            r = self._queue.popleft()
            try:
                # admission-time resolution: the request serves the
                # version the pointer names NOW, and the pin holds that
                # version's slot until it retires
                vslot, vkey = self.registry.bank_acquire(r.variant)
            except RuntimeError:
                # every bank slot pinned by in-flight requests: retry
                # after retirements free pins
                self._queue.appendleft(r)
                break
            except Exception as e:
                r.retries += 1
                if r.retries > self.max_retries:
                    r.status, r.error = "failed", str(e)
                    self._done[r.rid] = r
                    self.metrics["failed"] += 1
                else:
                    self._queue.append(r)
                continue
            i = free.pop(0)
            r.served_version = self.registry.current_version(r.variant)
            self._slots[i] = _Slot(request=r, variant_slot=vslot,
                                   remaining=r.max_new_tokens, vkey=vkey)
            self._variant_idx[i] = vslot
            self._variant_idx_dev = None
            r.status = "running"
            newly.append(i)
            self.metrics["admitted"] += 1
        return newly

    def _bank_tree(self):
        bank = self.registry.bank
        return bank.tree if bank is not None else None

    def _prefill_admitted(self, newly: list) -> None:
        """Prefill-on-admit: one fixed-shape (batch_size, prompt_len)
        prefill per admission wave, rows not admitted on the base slot;
        only the newly admitted rows of its cache and first tokens are
        merged into the persistent batch."""
        pvidx = np.zeros(self.batch_size, np.int32)
        for i in newly:
            pvidx[i] = self._slots[i].variant_slot
        batch = self._prompt_batch(
            {i: self._slots[i].request for i in newly})
        t0 = time.perf_counter()
        last_logits, fresh = self.model.prefill(
            self.registry.base_params, batch, self.max_len,
            overlay=self._bank_tree(),
            variant_idx=torch.from_numpy(pvidx).to(self.device))
        first_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
        synchronize(self.device)
        self.metrics["prefill_seconds"] += time.perf_counter() - t0
        self.metrics["prefills"] += 1
        if self._next_tok is None:
            self._next_tok = first_tok
            self._cache = fresh
            return
        mask = np.zeros(self.batch_size, bool)
        mask[newly] = True
        self._next_tok = torch.where(torch.from_numpy(mask).to(self.device),
                                     first_tok, self._next_tok)
        self._cache = self._merge_admitted(self._cache, fresh, newly)

    def _retire(self, i: int) -> None:
        """Release lane ``i``: mark its request done, unpin the bank slot
        it decoded from, and free the lane for the next admission wave."""
        s = self._slots[i]
        s.request.status = "done"
        self._done[s.request.rid] = s.request
        self.registry.bank_unpin(s.vkey)
        self._slots[i] = None
        self._variant_idx[i] = 0
        self._variant_idx_dev = None
        self.metrics["retired"] += 1

    def _serve_lanes(self, max_rounds: int, advance) -> None:
        """The slot scheduler's loop: free lanes admit queued requests
        (prefill-on-admit), every active lane appends its PENDING token
        (a prefill argmax, a decode step's or a round's; one host sync),
        exhausted lanes retire at once, then ``advance()`` moves the batch
        on: one decode step (continuous) or one speculative round."""
        # max_rounds bounds STALLED rounds (no admission, no token, no
        # failure), not decode steps: productive rounds are bounded by the
        # submitted token budgets
        stalls = 0
        while (self._queue or self.active()) and stalls < max_rounds:
            failed0 = self.metrics["failed"]
            newly = self._admit_free_slots()
            if newly:
                self._prefill_admitted(newly)
            if not self.active():
                if not self._queue:
                    break
                # admissions failed this round: retry (a stall unless
                # requests were failed — retries terminate)
                stalls = 0 if self.metrics["failed"] > failed0 \
                    else stalls + 1
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
            if self._variant_idx_dev is None:
                self._variant_idx_dev = torch.from_numpy(
                    self._variant_idx.copy()).to(self.device)
            advance()
        self.metrics["batches"] += 1

    def _decode_step(self) -> None:
        """One banked decode step of the whole batch: each lane's next
        pending token."""
        t0 = time.perf_counter()
        logits, self._cache = self.model.decode_step(
            self.registry.base_params, self._next_tok, self._cache,
            overlay=self._bank_tree(), variant_idx=self._variant_idx_dev)
        self._next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        synchronize(self.device)
        self.metrics["decode_seconds"] += time.perf_counter() - t0
        self.metrics["decode_steps"] += 1

    def _spec_round(self) -> None:
        """One speculative round of the current draft length k: drafts on
        the base weights, one banked verify through each lane's slot.  Each
        lane appends its n_acc accepted drafts (within its budget; a lane
        that spends it retires, and its pending correction, past
        max_new_tokens, is dropped); the next pending token is the
        variant's correction."""
        params, bank = self.registry.spec_resolve()
        k = self.spec.current_k
        t0 = time.perf_counter()
        ver, n_acc, self._next_tok, self._cache = self._rounds[k](
            params, bank, self._variant_idx_dev, self._next_tok,
            self._cache)
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

    def _prompt_batch(self, requests: dict) -> dict:
        """Fixed-shape (batch_size, prompt_len) prefill batch: row i holds
        requests[i]'s prompt tail, right-padded with zeros; unmapped rows
        stay zero; plus the frontend stub's inputs.  The one place prompt
        padding happens: both schedulers build identical batches."""
        toks = np.zeros((self.batch_size, self.prompt_len), np.int64)
        for i, r in requests.items():
            p = r.tokens[-self.prompt_len:]
            toks[i, :len(p)] = p
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        batch.update(frontend_stub(self.model.cfg, self.batch_size,
                                   self.device))
        return batch


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
