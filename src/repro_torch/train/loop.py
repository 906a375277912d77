"""Fault-tolerant training loop (port of ``repro.train.loop``):
checkpoint, auto-resume, preemption.

Contract:
* deterministic data: batch i is a pure function of (seed, i)
  (``data/pipeline.SyntheticLM``), so a restart at step N replays exactly
  the stream a run without the failure would have seen;
* auto-resume: on start, the newest VALID checkpoint is restored (torn
  checkpoints from a dead writer are skipped by the manager);
* preemption-safe: ``interrupt_at`` (tests) and SIGTERM (its handler is
  installed when ``run`` is called on the main thread, and put back after)
  both exit after finishing the current step and saving it;
* optional 1-bit gradient compression with error feedback
  (``distributed/compression.py``), its error state threaded through the
  steps.

Elastic re-meshing (the JAX module's ``remesh``) needs a device mesh and
is not ported yet.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import compression as GC
from repro_torch.models.model_zoo import Model
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    batch_size: int = 4
    seq_len: int = 64
    peak_lr: float = 3e-4
    warmup: int = 10
    seed: int = 0
    grad_compress: bool = False


class Trainer:
    """Trains ``model`` from ``LoopConfig.seed`` on ``device`` (default
    ``cuda``), checkpointing into ``ckpt_dir``."""

    def __init__(self, model: Model, ckpt_dir,
                 loop_cfg: Optional[LoopConfig] = None, *, device=None):
        self.model = model
        self.cfg = loop_cfg or LoopConfig()
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.data = SyntheticLM(model.cfg.vocab_size, self.cfg.seed)
        self._interrupted = False
        self.ef_state = None
        self._ef_transform, self._ef_init = GC.make_ef_transform()
        self._step = make_train_step(
            model, peak_lr=self.cfg.peak_lr, warmup=self.cfg.warmup,
            total_steps=self.cfg.total_steps,
            grad_transform=self._ef_hook if self.cfg.grad_compress else None)

    def _ef_hook(self, grads):
        """Compress the gradients with error feedback, carrying the error
        state to the next step."""
        grads, self.ef_state = self._ef_transform(grads, self.ef_state)
        return grads

    def _install_sigterm(self):
        """The SIGTERM handler (main thread only: Python delivers signals
        there); returns the handler it replaced, or None."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def handler(signum, frame):
            self._interrupted = True
        return signal.signal(signal.SIGTERM, handler)

    def run(self, interrupt_at: Optional[int] = None) -> dict:
        """Train to ``total_steps``, resuming from the newest valid
        checkpoint.  ``interrupt_at`` simulates a preemption after that
        step.  Returns {"state", "losses", "completed", "interrupted",
        "step_seconds"} (each step's host time, to its loss's arrival)."""
        previous = self._install_sigterm()
        try:
            return self._run(interrupt_at)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, interrupt_at: Optional[int]) -> dict:
        state = init_train_state(self.model, self.cfg.seed, self.device)
        restored, state = self.ckpt.restore_latest(state)
        start = state.step if restored is not None else 0
        if self.cfg.grad_compress:
            self.ef_state = self._ef_init(state.params)

        losses, step_seconds = [], []
        for step in range(start, self.cfg.total_steps):
            batch = self.data.lm_batch(step, self.cfg.batch_size,
                                       self.cfg.seq_len)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            losses.append(float(metrics["loss"]))
            step_seconds.append(time.perf_counter() - t0)
            done = step + 1
            saved = (done % self.cfg.ckpt_every == 0
                     or done == self.cfg.total_steps)
            if saved:
                self.ckpt.save(done, state)
            if interrupt_at is not None and done >= interrupt_at:
                self._interrupted = True
            if self._interrupted:
                if not saved:
                    self.ckpt.save(done, state)   # emergency save
                return {"state": state, "losses": losses, "completed": done,
                        "interrupted": True, "step_seconds": step_seconds}
        return {"state": state, "losses": losses,
                "completed": self.cfg.total_steps, "interrupted": False,
                "step_seconds": step_seconds}
