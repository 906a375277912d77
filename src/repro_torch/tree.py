"""Minimal pytree helpers over the port's parameter containers.

Trees are nested dicts, lists and tuples, plus dataclasses (``Param``,
``OverlayEntry``, ``DeltaEntry``).  Tensors are the leaves; any other
non-container value (None, a bool flag) is carried through untouched —
the counterpart of ``jax.tree.map`` for the containers this package uses.
"""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out
