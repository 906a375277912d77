"""Parameter containers: tensors carry their logical axis names at init
(port of ``repro.models.param``).

``split(params)`` separates a tree of :class:`Param` into (tensors,
logical axes).  Initialisers draw from an explicit ``torch.Generator``;
they do not reproduce ``jax.random`` numbers — tests that compare the two
packages cross weights through ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class Param:
    value: torch.Tensor
    axes: tuple


def dense_init(gen: torch.Generator, shape: Sequence[int],
               axes: Sequence[Optional[str]], scale: Optional[float] = None,
               dtype=torch.float32) -> Param:
    """Normal init with std = scale or 1/sqrt(fan_in); weights are
    (d_out, d_in), fan_in is the last dim.  Drawn on the generator's
    device."""
    fan_in = shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    val = torch.randn(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32) * std
    assert len(axes) == len(shape), (axes, shape)
    return Param(val.to(dtype), tuple(axes))


def zeros_init(shape, axes, device, dtype=torch.float32) -> Param:
    return Param(torch.zeros(tuple(shape), dtype=dtype, device=device),
                 tuple(axes))


def ones_init(shape, axes, device, dtype=torch.float32) -> Param:
    return Param(torch.ones(tuple(shape), dtype=dtype, device=device),
                 tuple(axes))


def _is_param(x) -> bool:
    return isinstance(x, Param)


def _map_params(fn, tree):
    if _is_param(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_params(fn, v) for k, v in tree.items()}
    raise TypeError(f"unexpected node {type(tree)} in a Param tree")


def split(params):
    """(tree of Param) -> (tree of tensors, tree of logical-axis tuples)."""
    return (_map_params(lambda p: p.value, params),
            _map_params(lambda p: p.axes, params))


def stack_layers(init_fn, gen: torch.Generator, n: int):
    """Initialise ``n`` copies of a block (each drawing from ``gen`` in
    turn) and stack each leaf along a new leading "layers" axis."""
    per_layer = [init_fn(gen) for _ in range(n)]

    def stack(path_node, nodes):
        if _is_param(path_node):
            return Param(torch.stack([p.value for p in nodes]),
                         ("layers",) + path_node.axes)
        return {k: stack(path_node[k], [nd[k] for nd in nodes])
                for k in path_node}

    return stack(per_layer[0], per_layer)
