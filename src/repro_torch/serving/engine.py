"""Serving engine, group scheduler (port of ``scheduler="group"`` of
``repro.serving.engine``).

Pending requests are grouped BY VARIANT (the FIFO head decides), and each
group runs one prefill over a fixed (batch_size, prompt_len) batch plus
decode steps up to the largest token budget in the group.  Variants
resolve to (params, overlay): dense residents pass a materialised copy
with overlay None; fused residents pass the shared base params plus a
packed overlay fused into every GEMM.

PyTorch runs eagerly, so there is no step compilation or warmup.  The
continuous and speculative schedulers are not ported yet.
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


class ServingEngine:
    """Fixed-shape batched serving: groups of ``batch_size``, prompts padded
    to ``prompt_len``, KV capacity ``max_len``."""

    scheduler = "group"   # the continuous scheduler is not ported yet

    def __init__(self, model, registry: VariantRegistry, *,
                 batch_size: int = 4, prompt_len: int = 32,
                 max_len: int = 128, max_retries: int = 1):
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
        self.metrics = {"batches": 0, "tokens_generated": 0, "prefills": 0,
                        "failed": 0, "decode_steps": 0,
                        "prefill_seconds": 0.0, "decode_seconds": 0.0,
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
        """The Request wherever it lives (done or queued); None if unknown."""
        if rid in self._done:
            return self._done[rid]
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
        return {"scheduler": self.scheduler, "pending": self.pending(),
                "ttft": {"count": n,
                         "mean_seconds": (self.metrics["ttft_seconds_sum"]
                                          / n if n else 0.0),
                         "max_seconds": self.metrics["ttft_seconds_max"]},
                "metrics": dict(self.metrics)}

    def pending(self) -> int:
        return len(self._queue)

    def run_until_drained(self, max_rounds: int = 1000) -> dict:
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
        except KeyError as e:   # unknown variant/version: re-queue or fail
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

    def _prompt_batch(self, requests: dict) -> dict:
        """Fixed-shape (batch_size, prompt_len) prefill batch: row i holds
        requests[i]'s prompt tail, right-padded with zeros; unmapped rows
        stay zero."""
        toks = np.zeros((self.batch_size, self.prompt_len), np.int64)
        for i, r in requests.items():
            p = r.tokens[-self.prompt_len:]
            toks[i, :len(p)] = p
        return {"tokens": torch.from_numpy(toks).to(self.device)}
