"""Calibration pipeline (port of ``repro.core.calibration``): the paper's
Alg. 1-7 on tensors, plus the flat dot-path scheme every flat view of a
parameter tree shares.

Stages:
  0. ``compress``: B = sign(W_f − W_b) packed; v0 = mean(|ΔW|) per row and
     per column, both kept for every target matrix.
  1. per-layer activation matching (``_fit_scale``): from caches of (X, Y)
     pairs — X from the student stack (compressed layers below), Y from the
     teacher — fit v by output MSE with AdamW.
  2. axis selection (``fit_layer``): row vs col by held-out MSE, per matrix.
  3. end-to-end logit matching (``e2e_calibrate``): train all scale vectors
     jointly so the stacked student reproduces the teacher's logits.

``calibrate_transformer`` (decoder families) and ``calibrate_encdec``
(whisper: encoder stack, then decoder stack) run the four in order, on the
base's device.
Gradients come from torch autograd on leaf scale tensors where the JAX
package uses ``jax.value_and_grad``; the schedule (train/val split, batch
slicing, step counts) is the JAX package's exactly.

Targets are the linear projections of attention and MLP blocks
(``TARGET_KEYS``); every other leaf (norms, embeddings) travels as an
uncompressed fine-tuned extra.  Stacked weights keep their leading layer
dim: each stacked matrix gets its own scales and axis choice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import delta as D
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.tree import tree_leaves

TARGET_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "w_in", "w_out", "w_ff1", "w_ff2", "w_zi", "w_if",
               "w_z", "w_xc", "w_bc", "w_dt"}


# ---------------------------------------------------------------------------
# path utilities
# ---------------------------------------------------------------------------

def flatten_params(params) -> dict:
    """{dot-path -> tensor}.  Dict keys are visited in sorted order and
    list entries by index, as ``jax.tree_util`` flattens — so paths and
    their order equal the JAX package's."""
    flat: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            flat[".".join(prefix)] = node

    walk(params, ())
    return flat


def unflatten_like(template, flat: dict):
    """Rebuild ``template``'s nesting with leaves taken from ``flat``."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return flat[".".join(prefix)]

    return build(template, ())


def is_target(path: str, arr) -> bool:
    last = path.split(".")[-1]
    return (last in TARGET_KEYS and arr.dim() >= 2
            and arr.shape[-1] % 8 == 0 and "conv" not in path)


# ---------------------------------------------------------------------------
# delta model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeltaEntry:
    """One target matrix stack: packed sign mask + both axis variants."""
    packed: torch.Tensor         # (..., dout, din//8) uint8
    v_row: torch.Tensor          # (..., dout)
    v_col: torch.Tensor          # (..., din)
    use_row: torch.Tensor        # (...,) bool — per stacked matrix
    scalar: bool = False

    def reconstruct(self, w_base: torch.Tensor, dtype=None) -> torch.Tensor:
        dtype = dtype or w_base.dtype
        signs = D.unpack_signs(self.packed, w_base.shape[-1], torch.float32)
        if self.scalar:
            dv = self.v_row[..., None, None].to(torch.float32) * signs
        else:
            dr = self.v_row[..., :, None].to(torch.float32) * signs
            dc = self.v_col[..., None, :].to(torch.float32) * signs
            dv = torch.where(self.use_row[..., None, None], dr, dc)
        return (w_base.to(torch.float32) + dv).to(dtype)

    def artifact_bytes(self) -> int:
        """On-disk bytes: packed mask + the SELECTED fp16 vector per matrix
        + 1 selector bit per matrix (scalar mode: 2 bytes per matrix)."""
        mask = self.packed.numel()
        if self.scalar:
            return mask + 2 * self.v_row.numel()
        n_mats = max(self.use_row.numel(), 1)
        d_out = self.v_row.shape[-1]
        d_in = self.v_col.shape[-1]
        n_row = int(self.use_row.sum())
        vec = 2 * (n_row * d_out + (n_mats - n_row) * d_in)
        return mask + vec + (n_mats + 7) // 8


@dataclasses.dataclass
class DeltaModel:
    deltas: dict                 # path -> DeltaEntry
    extras: dict                 # path -> fine-tuned value (uncompressed)
    # the mesh whose rank's blocks the leaves are (``loader.place_delta_
    # model``); None for a whole (global) variant
    placed: object = None

    def scale_params(self) -> dict:
        """The trainable tree (v_row/v_col per target)."""
        return {k: {"v_row": e.v_row, "v_col": e.v_col}
                for k, e in self.deltas.items()}

    def with_scales(self, scales: dict) -> "DeltaModel":
        new = {k: dataclasses.replace(e, v_row=scales[k]["v_row"],
                                      v_col=scales[k]["v_col"])
               for k, e in self.deltas.items()}
        return DeltaModel(deltas=new, extras=self.extras)


def compress(base_params, ft_params, scalar: bool = False) -> DeltaModel:
    """Stage 0: masks + init scales for every target; fine-tuned extras
    for the rest (embeddings, norms)."""
    base_flat = flatten_params(base_params)
    ft_flat = flatten_params(ft_params)
    deltas, extras = {}, {}
    for path, wb in base_flat.items():
        wf = ft_flat[path]
        if is_target(path, wb):
            dw = (wf - wb).to(torch.float32)
            packed = D.pack_signs(D.sign_mask(dw))
            use_row = torch.ones(dw.shape[:-2], dtype=torch.bool,
                                 device=dw.device)
            if scalar:
                v0 = D.init_scale(dw, "scalar")
                deltas[path] = DeltaEntry(packed=packed, v_row=v0, v_col=v0,
                                          use_row=use_row, scalar=True)
            else:
                deltas[path] = DeltaEntry(
                    packed=packed, v_row=D.init_scale(dw, "row"),
                    v_col=D.init_scale(dw, "col"), use_row=use_row)
        else:
            extras[path] = wf
    return DeltaModel(deltas=deltas, extras=extras)


def apply_delta(base_params, dm: DeltaModel):
    """Materialise the student parameters (plain PyTorch path)."""
    out = {}
    for path, wb in flatten_params(base_params).items():
        if path in dm.deltas:
            out[path] = dm.deltas[path].reconstruct(wb)
        else:
            out[path] = dm.extras.get(path, wb)
    return unflatten_like(base_params, out)


def artifact_nbytes(dm: DeltaModel) -> int:
    total = sum(e.artifact_bytes() for e in dm.deltas.values())
    total += sum(2 * v.numel() for v in dm.extras.values())  # fp16 extras
    return total


def fp16_checkpoint_nbytes(params) -> int:
    return sum(2 * t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Stage 1/2: per-layer activation matching + axis selection (Alg. 3/4/6)
# ---------------------------------------------------------------------------

def _fit_scale(packed, w_base, x, y, v0, mode, *, epochs: int = 5,
               lr: float = 1e-4, batch: int = 1024, val_frac: float = 0.2):
    """Fit one matrix's scale vector by output MSE; returns (v, val_mse).

    x: (N, din), y: (N, dout) — the calibration cache for this layer.  The
    last ``val_frac`` of the rows is held out; training walks the rest in
    slices of ``min(batch, n_train)`` rows."""
    n = x.shape[0]
    n_val = max(1, int(n * val_frac))
    x_tr, y_tr = x[:-n_val], y[:-n_val]
    x_val, y_val = x[-n_val:], y[-n_val:]
    n_tr = x_tr.shape[0]
    bs = min(batch, n_tr)
    steps_per_epoch = max(1, n_tr // bs)
    total_steps = epochs * steps_per_epoch

    def mse(v, xb, yb):
        pred = D.delta_matmul(xb.to(torch.float32), packed, v, w_base, mode)
        return torch.mean((pred - yb.to(torch.float32)) ** 2)

    v = v0.to(torch.float32)
    opt = adamw_init({"v": v})
    for i in range(total_steps):
        start = (i * bs) % max(n_tr - bs + 1, 1)
        xb, yb = x_tr[start:start + bs], y_tr[start:start + bs]
        leaf = v.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(mse(leaf, xb, yb), [leaf])
        new, opt, _ = adamw_update({"v": v}, {"v": g}, opt, lr=lr,
                                   weight_decay=0.0, grad_clip_norm=1e9)
        v = new["v"]
    with torch.no_grad():
        return v, mse(v, x_val, y_val)


def fit_layer(entry: DeltaEntry, w_base_l, x, y, layer_idx=None, *,
              epochs: int = 5, lr: float = 1e-4):
    """Alg. 6 for one matrix: fit row and col variants, select by val MSE.

    entry fields may be stacked; ``layer_idx`` selects the matrix.
    Returns (v_row, v_col, use_row, val_mses)."""
    def pick(t):
        return t if layer_idx is None else t[layer_idx]
    packed = pick(entry.packed)
    v_r, mse_r = _fit_scale(packed, w_base_l, x, y, pick(entry.v_row),
                            "row", epochs=epochs, lr=lr)
    v_c, mse_c = _fit_scale(packed, w_base_l, x, y, pick(entry.v_col),
                            "col", epochs=epochs, lr=lr)
    return v_r, v_c, bool(mse_r <= mse_c), (float(mse_r), float(mse_c))


# ---------------------------------------------------------------------------
# Stage 3: end-to-end logit matching (Alg. 2)
# ---------------------------------------------------------------------------

def e2e_calibrate(forward_fn: Callable, base_params, dm: DeltaModel,
                  teacher_logits: list, batches: list, *,
                  epochs: int = 5, lr: float = 1e-4):
    """Jointly train all scale vectors to match teacher logits.

    forward_fn(params, batch) -> logits; teacher_logits[i] pre-computed (the
    paper caches them — Alg. 5).  Returns (DeltaModel, per-step losses)."""
    scales = dm.scale_params()
    opt = adamw_init(scales)
    losses = []
    for _ in range(epochs):
        for batch, tl in zip(batches, teacher_logits):
            leaves = {k: {f: t.detach().requires_grad_(True)
                          for f, t in sv.items()}
                      for k, sv in scales.items()}
            keys = [(k, f) for k, sv in leaves.items() for f in sv]
            with torch.enable_grad():
                student = apply_delta(base_params, dm.with_scales(leaves))
                logits = forward_fn(student, batch)
                loss = torch.mean((logits.to(torch.float32)
                                   - tl.to(torch.float32)) ** 2)
                grads = torch.autograd.grad(
                    loss, [leaves[k][f] for k, f in keys], allow_unused=True)
            # a vector the student does not read (a scalar entry's v_col)
            # gets a zero gradient, as jax.grad gives it
            g: dict = {k: {} for k in leaves}
            for (k, f), gr in zip(keys, grads):
                g[k][f] = torch.zeros_like(leaves[k][f]) if gr is None else gr
            del student, logits, leaves, grads
            scales, opt, _ = adamw_update(scales, g, opt, lr=lr,
                                          weight_decay=0.0,
                                          grad_clip_norm=1e9)
            losses.append(float(loss.detach()))
    return dm.with_scales(scales), losses


# ---------------------------------------------------------------------------
# full pipeline for the transformer family (uses IO capture)
# ---------------------------------------------------------------------------

def _on(batch: dict, device) -> dict:
    """A batch's token array as a long tensor on ``device``, and its
    encoder ``frames`` (audio family), if any, as fp32."""
    out = {"tokens": torch.as_tensor(batch["tokens"],
                                     device=device).to(torch.int64)}
    if "frames" in batch:
        out["frames"] = torch.as_tensor(batch["frames"], device=device,
                                        dtype=torch.float32)
    return out


def _put(t, li, value):
    """``t`` with index ``li`` replaced (a new tensor, as ``.at[].set``)."""
    out = t.clone()
    out[li] = value
    return out


def _fit_entry(entry: DeltaEntry, w_base_l, x, y, li: int, *, scalar: bool,
               epochs: int, lr: float, report: dict,
               name: str) -> DeltaEntry:
    """Stages 1-2 for matrix ``li`` of a stacked entry from its (X, Y)
    cache: the entry with that matrix's scales (and axis) refitted; its
    held-out MSE (row and col, or the scalar's) and axis choice go into
    ``report`` under ``name``."""
    if scalar:
        v, mse = _fit_scale(entry.packed[li], w_base_l, x, y, entry.v_row[li],
                            "scalar", epochs=epochs, lr=lr)
        report["val_mse"].setdefault(name, []).append(float(mse))
        return dataclasses.replace(entry, v_row=_put(entry.v_row, li, v),
                                   v_col=_put(entry.v_col, li, v))
    v_r, v_c, use_row, mses = fit_layer(entry, w_base_l, x, y, li,
                                        epochs=epochs, lr=lr)
    report["val_mse"].setdefault(name, []).append(mses)
    report["axis"].setdefault(name, []).append("row" if use_row else "col")
    return dataclasses.replace(entry, v_row=_put(entry.v_row, li, v_r),
                               v_col=_put(entry.v_col, li, v_c),
                               use_row=_put(entry.use_row, li, use_row))


def calibrate_transformer(model, base_params, ft_params, batches: list, *,
                          epochs: int = 5, lr: float = 1e-4,
                          e2e_epochs: int = 5, e2e_lr: float = 1e-4,
                          sequential: bool = True, scalar: bool = False,
                          progress: Optional[Callable] = None):
    """Alg. 1: caches -> per-layer fits -> axis select -> e2e, on the
    base's device.

    ``sequential=True`` rebuilds the student cache after each block is
    installed (X from the already-compressed stack below, paper §2);
    ``False`` takes the inputs of every layer from the stage-0 student.
    ``batches`` are dicts with "tokens" (numpy or tensors).  Returns
    (DeltaModel, report dict)."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    device = tree_leaves(base_params)[0].device
    batches = [_on(b, device) for b in batches]
    dm = compress(base_params, ft_params, scalar=scalar)
    cal_batch = {"tokens": torch.cat([b["tokens"] for b in batches], dim=0)}

    with torch.no_grad():
        t_io = T.forward(ft_params, cal_batch, cfg, collect_io=True)[1]["io"]

    if scalar:
        # BitDelta baseline: single scalar per matrix, 1 epoch (paper §3.1)
        epochs = 1

    layer_keys = [k for k in dm.deltas if k.startswith("layers.")]
    n_layers = dm.deltas[layer_keys[0]].packed.shape[0] if layer_keys else 0
    base_flat = flatten_params(base_params)
    report = {"val_mse": {}, "axis": {}}

    s_io = None
    for li in range(n_layers):
        if sequential or s_io is None:
            with torch.no_grad():
                student = apply_delta(base_params, dm)
                s_io = T.forward(student, cal_batch, cfg,
                                 collect_io=True)[1]["io"]
                del student
        new_deltas = dict(dm.deltas)
        for key in layer_keys:
            proj = ".".join(key.split(".")[1:])    # e.g. "attn.wq"
            x_all, _ = s_io[proj]
            _, y_all = t_io[proj]
            x = x_all[li].reshape(-1, x_all.shape[-1])
            y = y_all[li].reshape(-1, y_all.shape[-1])
            new_deltas[key] = _fit_entry(
                dm.deltas[key], base_flat[key][li], x, y, li, scalar=scalar,
                epochs=epochs, lr=lr, report=report, name=proj)
        dm = DeltaModel(deltas=new_deltas, extras=dm.extras)
        if progress:
            progress(li, n_layers)
    del s_io, t_io

    # non-stacked targets keep their weight-space init; the e2e stage below
    # trains their vectors too.

    # Stage 3: end-to-end
    def fwd(p, b):
        return T.forward(p, b, cfg)[0]

    with torch.no_grad():
        teacher_logits = [fwd(ft_params, b) for b in batches]
    dm, e2e_losses = e2e_calibrate(fwd, base_params, dm, teacher_logits,
                                   batches, epochs=e2e_epochs, lr=e2e_lr)
    report["e2e_losses"] = e2e_losses
    return dm, report


# ---------------------------------------------------------------------------
# encoder-decoder (whisper) family
# ---------------------------------------------------------------------------

def calibrate_encdec(model, base_params, ft_params, batches: list, *,
                     epochs: int = 5, lr: float = 1e-4,
                     e2e_epochs: int = 5, e2e_lr: float = 1e-4,
                     scalar: bool = False):
    """Alg. 1 for the whisper family, on the base's device: the encoder
    stack first, then the decoder, each block-sequential (the student's
    IO cache rebuilt before every layer's fits), then the end-to-end stage
    on ``whisper.forward``.  ``batches`` are dicts with "tokens" and
    "frames" (numpy or tensors).  Returns (DeltaModel, report); the
    report's ``axis`` and ``val_mse`` are keyed "group.proj" (the JAX
    package leaves ``val_mse`` empty here)."""
    from repro_torch.models import whisper as W
    cfg = model.cfg
    device = tree_leaves(base_params)[0].device
    batches = [_on(b, device) for b in batches]
    dm = compress(base_params, ft_params, scalar=scalar)
    if scalar:
        epochs = 1
    cal_batch = {key: torch.cat([b[key] for b in batches], dim=0)
                 for key in ("tokens", "frames")}

    def fwd_io(p):
        with torch.no_grad():
            return W.forward(p, cal_batch, cfg, collect_io=True)[1]

    t_aux = fwd_io(ft_params)
    base_flat = flatten_params(base_params)
    report = {"val_mse": {}, "axis": {}}
    for group, io_key in (("enc_layers", "enc_io"), ("dec_layers", "dec_io")):
        keys = [k for k in dm.deltas if k.startswith(group + ".")]
        if not keys:
            continue
        n_layers = dm.deltas[keys[0]].packed.shape[0]
        for li in range(n_layers):
            s_aux = fwd_io(apply_delta(base_params, dm))
            new_deltas = dict(dm.deltas)
            for key in keys:
                proj = key[len(group) + 1:]
                x_all = s_aux[io_key][proj][0]
                y_all = t_aux[io_key][proj][1]
                x = x_all[li].reshape(-1, x_all.shape[-1])
                y = y_all[li].reshape(-1, y_all.shape[-1])
                new_deltas[key] = _fit_entry(
                    dm.deltas[key], base_flat[key][li], x, y, li,
                    scalar=scalar, epochs=epochs, lr=lr, report=report,
                    name=f"{group}.{proj}")
            dm = DeltaModel(deltas=new_deltas, extras=dm.extras)
            del s_aux
    del t_aux

    def fwd(p, b):
        return W.forward(p, b, cfg)[0]

    with torch.no_grad():
        teacher_logits = [fwd(ft_params, b) for b in batches]
    dm, e2e_losses = e2e_calibrate(fwd, base_params, dm, teacher_logits,
                                   batches, epochs=e2e_epochs, lr=e2e_lr)
    report["e2e_losses"] = e2e_losses
    return dm, report
