"""Calibration stage 0 (port of ``repro.core.calibration``): sign masks and
initial per-axis scales for every target matrix, plus the flat dot-path
scheme every flat view of a parameter tree shares.

Targets are the linear projections of attention and MLP blocks
(``TARGET_KEYS``); every other leaf (norms, embeddings) travels as an
uncompressed fine-tuned extra.  Stacked weights keep their leading layer
dim: each stacked matrix gets its own scales and axis choice.

The trained stages (per-layer fits, axis selection, end-to-end logit
matching) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import delta as D
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
