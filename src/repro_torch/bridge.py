"""Numpy bridge between the JAX package and the port.

Both packages name parameters by the same flat dot-paths
(``core/calibration.flatten_params``), so weights and delta models cross
as ``{path: np.ndarray}`` dicts.  bf16 leaves cross as ``uint16`` bit
patterns (numpy has no bf16 of its own); a numpy array whose dtype is named
``bfloat16`` is accepted as well.  An int8-quantized base leaf
(``core/quantize.QuantWeight``) crosses as ``{"q": int8 array, "scale":
fp16 array}``, its bytes and scale bits unchanged.  This module never
imports JAX: the caller flattens the JAX side and hands numpy arrays over.

DeltaModel exchange format::

    {"deltas": {path: {"packed", "v_row", "v_col", "use_row": arrays,
                       "scalar": bool}},
     "extras": {path: array}}
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import (DeltaEntry, DeltaModel,
                                          flatten_params)
from repro_torch.core.quantize import QuantWeight, is_quant


def to_tensor(arr, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``; uint16 / bfloat16 -> bf16."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy array on the host; bf16 -> uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_leaf(a, device):
    """One params leaf from the exchange format: an array -> tensor, a
    ``{"q", "scale"}`` pair -> QuantWeight."""
    if isinstance(a, dict):
        return QuantWeight(q=to_tensor(a["q"], device),
                           scale=to_tensor(a["scale"], device))
    return to_tensor(a, device)


def leaf_to_numpy(t):
    """Inverse of :func:`to_leaf`."""
    if is_quant(t):
        return {"q": to_numpy(t.q), "scale": to_numpy(t.scale)}
    return to_numpy(t)


def nest(flat: dict) -> dict:
    """{dot-path -> leaf} -> nested dicts (the params tree layout)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def params_from_numpy(flat: dict, device) -> dict:
    """{path: np.ndarray or quantized pair} -> the port's nested params
    tree on ``device``."""
    return nest({p: to_leaf(a, device) for p, a in flat.items()})


def params_to_numpy(params) -> dict:
    """The port's params tree -> {path: np.ndarray or quantized pair}."""
    return {p: leaf_to_numpy(t) for p, t in flatten_params(params).items()}


def delta_model_from_numpy(d: dict, device) -> DeltaModel:
    deltas = {
        path: DeltaEntry(packed=to_tensor(e["packed"], device),
                         v_row=to_tensor(e["v_row"], device),
                         v_col=to_tensor(e["v_col"], device),
                         use_row=to_tensor(e["use_row"], device),
                         scalar=bool(e["scalar"]))
        for path, e in d["deltas"].items()}
    extras = {p: to_tensor(a, device) for p, a in d["extras"].items()}
    return DeltaModel(deltas=deltas, extras=extras)


def delta_model_to_numpy(dm: DeltaModel) -> dict:
    return {
        "deltas": {path: {"packed": to_numpy(e.packed),
                          "v_row": to_numpy(e.v_row),
                          "v_col": to_numpy(e.v_col),
                          "use_row": to_numpy(e.use_row),
                          "scalar": e.scalar}
                   for path, e in dm.deltas.items()},
        "extras": {p: to_numpy(t) for p, t in dm.extras.items()},
    }
