"""Training, evaluation and serving step functions (port of
``repro.train.step``).

``make_train_step(model)`` returns step(state, batch) -> (state,
metrics), functional as the JAX step is: the returned state holds new
tensors and the one passed in is left as it was.  Gradients come from
``torch.autograd.grad`` over fresh leaves that require grad (the
counterpart of ``jax.value_and_grad``); the update is the port's
``optim/adamw`` (JAX's clip, mask and bias correction) at the learning
rate of ``optim/schedule.cosine_schedule``.  ``make_prefill_step`` /
``make_decode_step`` and the banked and fused decode steps are the serving
equivalents.

Batches are dicts of numpy arrays or tensors ("tokens", "labels", plus
"frames" for the audio family and "image_embeds" for the VLM family), moved
to the device of the parameters.  ``param_axes`` (the gradient sharding
constraint of the JAX step) needs a device mesh, which the port does not
have yet: passing it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.model_zoo import Model
from repro_torch.models.param import split
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """``step`` and ``opt.count`` are Python ints (a checkpoint stores them
    as int32 scalars, as the JAX package does)."""
    step: int
    params: dict
    opt: AdamWState


def init_train_state(model: Model, seed: int = 0, device=None) -> TrainState:
    """Params drawn from ``seed`` on ``device`` (default ``cuda``), zero
    moments, step 0."""
    params, _ = split(model.init(seed, device=device))
    return TrainState(step=0, params=params, opt=adamw_init(params))


def batch_to(batch: dict, device) -> dict:
    """A batch on ``device``: integer arrays (tokens, labels) as int64,
    float arrays (frames, image embeddings) as fp32."""
    def one(a):
        t = torch.as_tensor(a, device=device)
        return t.to(torch.float32 if t.is_floating_point() else torch.int64)
    return {k: one(v) for k, v in batch.items()}


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked next-token cross-entropy in fp32 (labels already shifted by
    the data pipeline; -100 labels are ignored)."""
    valid = labels >= 0 if mask is None else mask
    labels_safe = torch.clamp(labels, min=0).to(torch.int64)
    ll = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -ll.gather(-1, labels_safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def make_loss_fn(model: Model, aux_weight: Optional[float] = None):
    """loss_fn(params, batch) -> (total, {"loss", "moe_aux"}): the LM loss
    over the label positions plus ``aux_weight`` (default the config's
    ``router_aux_weight``) times the MoE load-balancing loss."""
    cfg = model.cfg
    aux_w = cfg.router_aux_weight if aux_weight is None else aux_weight
    compute_dtype = dtype_of(cfg.compute_dtype)

    def loss_fn(params, batch):
        # the fp32 matrices cast to the compute dtype ONCE, before the layer
        # stack; gradients flow back through the cast into fp32
        params = tree_map(
            lambda w: w.to(compute_dtype)
            if w.dtype == torch.float32 and w.dim() >= 2 else w, params)
        device = tree_leaves(params)[0].device
        batch = batch_to(batch, device)
        logits, aux = model.forward(params, batch)
        labels = batch["labels"]
        # frontends may prepend positions (VLM image tokens): align the tail
        logits = logits[:, -labels.shape[1]:, :]
        loss = lm_loss(logits, labels)
        moe_aux = aux.get("moe_aux", torch.zeros((), device=device))
        return loss + aux_w * moe_aux, {"loss": loss, "moe_aux": moe_aux}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """-> (total, metrics, grads): ``loss_fn``'s value and the gradient of
    its total with respect to every leaf of ``params`` (zeros for a leaf
    the loss does not read, as ``jax.grad`` gives), all detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        total, metrics = loss_fn(leaves, batch)
        grads = iter(torch.autograd.grad(total, tree_leaves(leaves),
                                         allow_unused=True))

    def grad_of(t):
        g = next(grads)
        return torch.zeros_like(t) if g is None else g

    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(grad_of, leaves))


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1,
                    grad_transform: Optional[Callable] = None,
                    param_axes=None):
    """grad_transform(grads) -> grads: the hook gradient compression plugs
    into (``distributed/compression.make_ef_transform``)."""
    if param_axes is not None:
        raise NotImplementedError(
            "param_axes constrains gradients to a mesh's parameter "
            "shardings: training under a mesh arrives with the "
            "card-per-rank NCCL slice, beside CUDA graphs under a mesh "
            "(the port's mesh serves only)")
    loss_fn = make_loss_fn(model)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        total, metrics, grads = value_and_grad(loss_fn, state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = cosine_schedule(state.step, warmup, total_steps, peak_lr)
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr=lr, weight_decay=weight_decay)
        new_state = TrainState(step=state.step + 1, params=params, opt=opt)
        return new_state, {**metrics, **opt_metrics, "lr": lr,
                           "total_loss": total}

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    def eval_step(params, batch) -> dict:
        with torch.no_grad():
            return loss_fn(params, batch)[1]

    return eval_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model, max_len: int,
                      cache_dtype=torch.bfloat16):
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, max_len,
                                 cache_dtype=cache_dtype)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, token, cache):
        with torch.no_grad():
            return model.decode_step(params, token, cache)
    return decode_step


def make_banked_decode_step(model: Model):
    """Mixed-variant decode: every batch row fuses its own overlay-bank
    slot's packed delta (slot 0 = base)."""
    def banked_decode_step(params, bank, variant_idx, token, cache):
        with torch.no_grad():
            return model.decode_step(params, token, cache, overlay=bank,
                                     variant_idx=variant_idx)
    return banked_decode_step


def make_fused_decode_step(model: Model):
    """Single-variant on-the-fly decode: the whole batch fuses ONE packed
    delta overlay into every GEMM."""
    def fused_decode_step(params, overlay, token, cache):
        with torch.no_grad():
            return model.decode_step(params, token, cache, overlay=overlay)
    return fused_decode_step
