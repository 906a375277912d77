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

``Trainer`` is single-device, as the JAX module's is.  Elastic re-meshing
after losing ranks is :func:`remesh` (the new mesh's shape and the state's
spec tree, as the JAX function returns its shardings) and
:func:`drop_and_continue` (the caller's ``device_put`` of the JAX
docstring: the old blocks gathered whole, the smaller mesh's groups formed
from the ranks that remain, the state placed by ``remesh``'s specs).
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


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------

def state_specs(model: Model, mesh, rules: dict, param_axes=None):
    """The spec tree of a TrainState on ``mesh`` under ``rules``: the
    params' specs for the params and both moments, () (replicated) for
    the step and the count."""
    from repro_torch.distributed.sharding import tree_pspecs
    from repro_torch.models.param import split
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState
    shapes, axes = split(model.init(0, device="meta"))
    p_specs = tree_pspecs(shapes, axes if param_axes is None else param_axes,
                          rules, mesh)
    return TrainState(step=(), params=p_specs,
                      opt=AdamWState(mu=p_specs, nu=p_specs, count=()))


def remesh(model: Model, state, old_mesh, new_data: int, new_model: int,
           rules: dict):
    """Recompute the state's placement for a resized (data, model) mesh —
    drop-and-continue after losing ranks.  Returns ((new_data,
    new_model), the state's spec tree on that mesh), the counterpart of
    the JAX function's (mesh, state shardings); :func:`drop_and_continue`
    moves a state onto it."""
    from repro_torch.distributed.sharding import Mesh
    shape = (new_data, new_model)
    return shape, state_specs(model, Mesh(("data", "model"), shape), rules)


def drop_and_continue(state, old_specs, old_mesh, new_specs, new_shape):
    """Every rank of ``old_mesh`` gathers its state's blocks whole
    (``old_specs``), the ranks form the (data, model) mesh of
    ``new_shape`` from the first data·model ranks
    (``launch.mesh.sub_mesh``), and each of those keeps its blocks of
    ``new_specs`` (``sharding.place`` copies them: the whole state is
    freed).  Collective over the old mesh.  Returns (the new mesh, the
    placed state), or (None, None) on a rank that was dropped."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as LM
    whole = S.unplace(state, old_specs, old_mesh)
    mesh = LM.sub_mesh(*new_shape, device=old_mesh.device)
    if mesh is None:
        return None, None
    return mesh, S.place(whole, new_specs, mesh)
