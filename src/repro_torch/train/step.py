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
to the device of the parameters.

Under a mesh (``make_train_step(param_axes=)`` called inside
``sharding.shard_ctx(mesh, rules_for("train"))``, as JAX's step runs
inside ``with mesh, shard_ctx(mesh, rules)``) the step trains explicit
SPMD, one process a rank (``distributed/sharding.py``):

* the state: every leaf of ``params``, ``mu`` and ``nu`` is the rank's
  block of ``tree_pspecs(shapes, param_axes, rules, mesh)`` (``place``):
  TP over "model", FSDP over "data" (``"embed": ["data"]``);
* the batch: every rank is given the whole batch and keeps its rows of
  ``act_batch`` (split over "data"), of every field: the tokens and
  labels, the audio family's "frames", the VLM's "image_embeds";
* FSDP: after the cast to the compute dtype (so the wire carries it) each
  leaf is all-gathered over "data" and the forward runs on the blocks
  whole over "data"; the gradients come back summed into the rank's blocks
  (``sharding.all_gather(reduce_grad=True)``, a reduce-scatter), and a
  leaf that "data" does not split gets the sum over "data" whole
  (``sharding.enter``);
* the loss: each rank's rows' negative log-likelihood over the batch's
  label count (summed over "data"), so the ranks' losses sum to
  ``lm_loss`` over the whole batch; the MoE aux loss likewise
  (``models/moe.py``);
* the update: AdamW per block, its global-norm clip summed over every
  rank with each block counted once (``optim/adamw.py``);
* the metrics (``loss``, ``moe_aux``, ``grad_norm``, ``lr``) are the same
  on every rank.

Every family trains under a mesh, as the JAX step does (its step is
mesh-agnostic GSPMD): the decoder, MoE and VLM transformers, whisper's
encoder-decoder, xLSTM and Zamba.  The model code carries the gradients
across its collectives (``sharding.psum``, ``all_gather``, ``enter``),
the split RMSNorm included (``layers.rmsnorm(part=)``).  Off a mesh
``param_axes`` is a no-op, as JAX's sharding constraint is outside
one.
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


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> tuple:
    """(summed fp32 next-token negative log-likelihood over the valid
    positions, their count): -100 labels are ignored."""
    valid = labels >= 0 if mask is None else mask
    labels_safe = torch.clamp(labels, min=0).to(torch.int64)
    ll = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -ll.gather(-1, labels_safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum(), valid.sum()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked next-token cross-entropy in fp32 (labels already shifted by
    the data pipeline; -100 labels are ignored)."""
    total, count = nll_sum(logits, labels, mask)
    return total / torch.clamp(count, min=1)


def _cast_once(params, compute_dtype):
    """The fp32 matrices cast to the compute dtype ONCE, before the layer
    stack; gradients flow back through the cast into fp32."""
    return tree_map(lambda w: w.to(compute_dtype)
                    if w.dtype == torch.float32 and w.dim() >= 2 else w,
                    params)


def make_loss_fn(model: Model, aux_weight: Optional[float] = None):
    """loss_fn(params, batch) -> (total, {"loss", "moe_aux"}): the LM loss
    over the label positions plus ``aux_weight`` (default the config's
    ``router_aux_weight``) times the MoE load-balancing loss."""
    cfg = model.cfg
    aux_w = cfg.router_aux_weight if aux_weight is None else aux_weight
    compute_dtype = dtype_of(cfg.compute_dtype)

    def loss_fn(params, batch):
        params = _cast_once(params, compute_dtype)
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


# the mesh axis FSDP shards the parameters' "embed" dims over
# (``sharding.PARAM_RULES``)
FSDP_AXIS = "data"


class _MeshTrain:
    """The mesh half of a train step: per (mesh, rules) the state's spec
    tree and the layout of the blocks gathered over "data" (their specs
    without it), built once from the parameters' global shapes."""

    def __init__(self, model: Model, param_axes, aux_weight: float):
        self.model = model
        self.param_axes = param_axes
        self.aux_w = aux_weight
        self.compute_dtype = dtype_of(model.cfg.compute_dtype)
        self._shapes = None
        self._cache: dict = {}

    def shapes(self):
        if self._shapes is None:
            self._shapes = split(self.model.init(0, device="meta"))[0]
        return self._shapes

    def plan(self, mesh, rules) -> tuple:
        """(spec tree, gathered layout) of ``mesh`` under ``rules``."""
        from repro_torch.core.calibration import flatten_params
        from repro_torch.distributed import sharding as S
        from repro_torch.models.delta_overlay import flatten_axes
        if self._cache.get(mesh, (None,))[0] != rules:
            specs = S.tree_pspecs(self.shapes(), self.param_axes, rules,
                                  mesh)
            flat_specs = flatten_axes(specs)
            for path, spec in flat_specs.items():
                for part in spec:
                    if FSDP_AXIS in S._names(part) and part != FSDP_AXIS:
                        raise ValueError(f"{path}: spec entry {part} mixes "
                                         f"{FSDP_AXIS!r} with other axes")
            lay = S.Layout.from_specs(
                {p: tuple(t.shape) for p, t in flatten_params(
                    self.shapes()).items()},
                {p: S.without_axes(sp, FSDP_AXIS)
                 for p, sp in flat_specs.items()},
                flatten_axes(self.param_axes), mesh)
            self._cache[mesh] = (dict(rules), specs, lay)
        return self._cache[mesh][1:]

    def rows(self, mesh, rules, n: int):
        """The mesh axes the batch's ``n`` rows split over."""
        from repro_torch.distributed import sharding as S
        part = S.resolve_spec((n,), ("act_batch",), rules, mesh)[0]
        if part is None and mesh.axis_size(FSDP_AXIS) not in (None, 1):
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {mesh!r}'s {FSDP_AXIS!r} axis")
        return part

    def value_and_grad(self, params, batch, mesh, rules) -> tuple:
        """(total, metrics, grads) of the rank's blocks: the batch's
        losses (the same on every rank) and the gradients of the rank's
        blocks of the whole batch's loss."""
        from repro_torch.distributed import sharding as S
        specs, lay = self.plan(mesh, rules)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        device = tree_leaves(params)[0].device
        batch = batch_to(batch, device)
        n = next(iter(batch.values())).shape[0]
        rows = self.rows(mesh, rules, n)
        if rows is not None:
            batch = {k: v[S.block_slices(v.shape[:1], (rows,), mesh)]
                     for k, v in batch.items()}

        def gathered(spec, w):
            for dim, part in enumerate(spec):
                if part == FSDP_AXIS:
                    return S.all_gather(w, FSDP_AXIS, dim, mesh,
                                        reduce_grad=True)
            return S.enter(w, FSDP_AXIS, mesh)

        with torch.enable_grad():
            cast = _cast_once(leaves, self.compute_dtype)
            whole = S._map_axes(gathered, specs, cast)
            with S.shard_ctx(mesh, rules, lay, batch_axes=S._names(rows)):
                logits, aux = self.model.forward(whole, batch)
            labels = batch["labels"]
            total_nll, count = nll_sum(logits[:, -labels.shape[1]:, :],
                                       labels)
            count = S.psum(count, rows, mesh)
            loss = total_nll / torch.clamp(count, min=1)
            moe_aux = aux.get("moe_aux", torch.zeros((), device=device))
            total = loss + self.aux_w * moe_aux
            grads = iter(torch.autograd.grad(total, tree_leaves(leaves),
                                             allow_unused=True))

        def grad_of(t):
            g = next(grads)
            return torch.zeros_like(t) if g is None else g

        metrics = {"loss": S.psum(loss.detach(), rows, mesh),
                   "moe_aux": S.psum(moe_aux.detach(), rows, mesh)}
        total = metrics["loss"] + self.aux_w * metrics["moe_aux"]
        return total, metrics, tree_map(grad_of, leaves)


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1,
                    grad_transform: Optional[Callable] = None,
                    param_axes=None):
    """grad_transform(grads) -> grads: the hook gradient compression plugs
    into (``distributed/compression.make_ef_transform``).

    ``param_axes``: the logical-axes tree of the parameters.  Called
    inside an active ``sharding.shard_ctx`` the step trains on that mesh
    under its rules (the module docstring), the state being the rank's
    blocks; outside one it is a no-op."""
    loss_fn = make_loss_fn(model)
    mesh_train = None if param_axes is None else _MeshTrain(
        model, param_axes, model.cfg.router_aux_weight)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        from repro_torch.distributed import sharding as S
        mesh = S.active_mesh() if mesh_train is not None else None
        specs = None
        if mesh is None:
            total, metrics, grads = value_and_grad(loss_fn, state.params,
                                                   batch)
        else:
            rules = S.active_rules()
            if rules.get("_forward_only"):
                raise ValueError("a train step under a mesh needs the train "
                                 "rules (sharding.rules_for('train'))")
            specs = mesh_train.plan(mesh, rules)[0]
            total, metrics, grads = mesh_train.value_and_grad(
                state.params, batch, mesh, rules)
        if grad_transform is not None:
            grads = grad_transform(grads)
        lr = cosine_schedule(state.step, warmup, total_steps, peak_lr)
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr=lr, weight_decay=weight_decay,
            mesh=mesh, specs=specs)
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
