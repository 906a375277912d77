"""Deployment: the versioned variant lifecycle as one control plane (port
of ``repro.serving.api`` without a store).

    dep = Deployment(model, base_params)   # fused, continuous, device="cuda"
    v1  = dep.publish("support-bot", dm)
    rid = dep.submit(prompt, variant="support-bot")
    v2  = dep.update("support-bot", dm_next)             # hot-swap
    dep.drain()
    dep.status(rid)
    dep.rollback("support-bot")

Versions live in memory, as the JAX ``Deployment`` keeps them when it has
no store.  The deployment runs on ``device`` (default ``cuda``); the base
params are moved there.  ``scheduler="continuous"`` (the default) serves
mixed-variant batches from the overlay bank and needs ``mode="fused"``;
``scheduler="group"`` serves one variant per batch, dense or fused.
``base_dtype="int8"`` keeps the base's target matrices as int8 plus fp16
per-channel scales (``core/quantize``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.calibration import DeltaModel
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.variants import VariantRegistry
from repro_torch.tree import tree_map


class Deployment:
    """One resident base model, in-memory variant version lineages and a
    serving engine behind publish/update/rollback/submit/drain/status."""

    def __init__(self, model, base_params, *, mode: str = "fused",
                 scheduler: str = "continuous", batch_size: int = 4,
                 prompt_len: int = 32, max_len: int = 128,
                 bank_size: int = 8, max_resident: int = 8, device=None,
                 base_dtype: str = "fp"):
        if base_dtype not in ("fp", "int8"):
            raise ValueError(f"unknown base dtype {base_dtype!r}")
        if scheduler == "continuous" and mode != "fused":
            # the continuous scheduler admits through the overlay bank,
            # which is fused-only: accepting mode="dense" here would
            # silently serve fused residents
            raise ValueError(
                f"scheduler={scheduler!r} requires mode='fused' (mixed "
                "batches serve from the packed overlay bank); use "
                "scheduler='group' for dense residency")
        self.device = resolve_device(device)
        base_params = tree_map(lambda t: t.to(self.device), base_params)
        self.model = model
        # the registry fingerprints the fp base, then quantizes it
        self.registry = VariantRegistry(base_params,
                                        max_resident=max_resident, mode=mode,
                                        bank_size=bank_size,
                                        base_dtype=base_dtype)
        self.engine = ServingEngine(model, self.registry,
                                    batch_size=batch_size,
                                    prompt_len=prompt_len, max_len=max_len,
                                    scheduler=scheduler)

    # -- control plane -----------------------------------------------------
    def publish(self, name: str, dm: DeltaModel, *,
                mode: Optional[str] = None, wait: bool = False) -> int:
        """Register ``dm`` as the next version of ``name`` and point serving
        at it; ``wait=True`` makes it resident now.  Returns the version."""
        if mode == "dense" and self.engine.scheduler == "continuous":
            raise ValueError(
                "per-variant mode='dense' cannot serve under the "
                "continuous scheduler (overlay-bank admission is "
                "fused-only)")
        v = self.registry.next_version(name)
        self.registry.set_version(name, v, dm, mode=mode)
        self._after_swap(name, wait)
        return v

    def update(self, name: str, dm: DeltaModel, *, wait: bool = False) -> int:
        """Next version of an existing variant + atomic pointer move."""
        if not self.registry.has_variant(name):
            raise KeyError(f"unknown variant {name!r}; publish first")
        v = self.registry.next_version(name)
        self.registry.set_version(name, v, dm)
        self._after_swap(name, wait)
        return v

    def rollback(self, name: str, to_version: Optional[int] = None, *,
                 wait: bool = False) -> int:
        """Pointer move back to ``to_version`` (default: previous)."""
        v = self.registry.rollback(name, to_version)
        self._after_swap(name, wait)
        return v

    def _after_swap(self, name: str, wait: bool) -> None:
        """``wait=True`` makes the new current version resident now: a
        bank slot under the continuous scheduler, a dense or fused
        resident under the group scheduler."""
        if not wait:
            return
        if self.engine.scheduler == "continuous":
            self.registry.bank_resolve(name)
        else:
            self.registry.resolve(name)

    def current(self, name: str) -> Optional[int]:
        return self.registry.current_version(name)

    def versions(self, name: str) -> list:
        return self.registry.versions(name)

    def variants(self) -> list:
        return self.registry.registered()

    def close(self) -> None:
        """Nothing runs in the background of a synchronous deployment."""

    # -- data plane --------------------------------------------------------
    def submit(self, tokens, variant: str = "__base__",
               max_new_tokens: int = 16) -> int:
        return self.engine.submit(tokens, variant=variant,
                                  max_new_tokens=max_new_tokens)

    def drain(self, max_rounds: int = 1000) -> dict:
        return self.engine.run_until_drained(max_rounds)

    def result(self, rid: int) -> Request:
        return self.engine.result(rid)

    def status(self, rid: Optional[int] = None) -> dict:
        """With ``rid``: one request's lifecycle view (never raises);
        without: the engine snapshot."""
        if rid is None:
            return self.engine.status()
        r = self.engine.request(rid)
        if r is None:
            return {"status": "unknown", "rid": rid}
        return {"status": r.status, "rid": rid, "variant": r.variant,
                "version": r.served_version,
                "tokens_generated": len(r.out_tokens),
                "first_token_at": r.first_token_at,
                "ttft_seconds": (None if r.first_token_at is None
                                 else r.first_token_at - r.submitted_at),
                "error": r.error}

    @property
    def metrics(self) -> dict:
        return self.engine.metrics

    @property
    def stats(self) -> dict:
        """Registry swap/residency counters (hits, swaps, resident bytes)."""
        return self.registry.stats
