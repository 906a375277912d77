"""AdamW over dicts of tensors (port of ``repro.optim.adamw``).

Functional, as the JAX module is: ``adamw_update`` returns new parameters
and a new state and leaves its inputs untouched.  The same global-norm
clip (computed in fp32 even when the limit never binds), the same bias
correction and the same decay mask (only leaves with ``ndim >= 2``) as the
JAX package; ``torch.optim.AdamW`` clips and masks differently, so it is
not used.  Trees are nested dicts and lists of tensors
(``repro_torch.tree``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    mu: object
    nu: object
    count: int


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=0)


def _like(tree, leaves):
    """``tree``'s structure with its tensor leaves taken from ``leaves``,
    in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _held_once(spec: tuple, mesh) -> bool:
    """Whether this rank counts a block of ``spec``: the block is held by
    every rank that differs from it only along the mesh axes the spec
    does not use, and the one at coordinate 0 on each of them counts it."""
    from repro_torch.distributed.sharding import _names
    used = {n for part in spec for n in _names(part)}
    return all(mesh.coord(n) == 0 for n in mesh.axis_names if n not in used)


def _global_sq_norm(grads, mesh=None, specs=None) -> torch.Tensor:
    """Σ g² in fp32 over every leaf of ``grads``.  On a mesh the leaves
    are the rank's blocks of the spec tree ``specs``: each rank sums the
    blocks it counts (``_held_once``: a block replicated over "model", or
    over "data" where a leaf does not split, counts once) and the ranks'
    sums are summed, so every rank gets the whole tree's."""
    leaves = tree_leaves(grads)
    if mesh is None:
        return sum(torch.sum(torch.square(g.to(torch.float32)))
                   for g in leaves)
    from repro_torch.distributed import sharding as S
    counted: list = []
    S._map_axes(lambda spec, g: counted.append(g) if _held_once(spec, mesh)
                else None, specs, grads)
    local = sum((torch.sum(torch.square(g.to(torch.float32)))
                 for g in counted),
                torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    return S.psum(local, tuple(mesh.axis_names), mesh)


def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip_norm: float = 1.0,
                 mesh=None, specs=None):
    """Returns (new_params, new_state, metrics).  With ``mesh`` the trees
    hold the rank's blocks of the spec tree ``specs`` (a train step under
    a mesh): the clip's norm is the whole tree's (``_global_sq_norm``), and
    the moments and the update stay per block."""
    with torch.no_grad():
        gsq = _global_sq_norm(grads, mesh, specs)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)

        count = state.count + 1
        # bias corrections in fp32, as the JAX package computes them
        n = torch.tensor(float(count))
        c1 = 1 - torch.tensor(b1) ** n
        c2 = 1 - torch.tensor(b2) ** n

        def upd(p, g, m, v):
            # the clipped gradient one leaf at a time: a clipped copy of
            # every gradient at once would add a params-sized buffer
            g = g.to(torch.float32) * scale
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * torch.square(g)
            # device-tensor divisors: CUDA divides by a host scalar as a
            # product with its reciprocal, which rounds differently
            step = (m_new / c1.to(m.device)) / (
                torch.sqrt(v_new / c2.to(m.device)) + eps)
            if p.dim() >= 2:
                step = step + weight_decay * p.to(torch.float32)
            p_new = p.to(torch.float32) - lr * step
            return p_new.to(p.dtype), m_new, v_new

        new = [upd(*a) for a in zip(*(tree_leaves(t) for t in (
            params, grads, state.mu, state.nu)))]
    return (_like(params, [n[0] for n in new]),
            AdamWState(mu=_like(state.mu, [n[1] for n in new]),
                       nu=_like(state.nu, [n[2] for n in new]), count=count),
            {"grad_norm": gnorm})
