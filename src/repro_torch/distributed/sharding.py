"""Logical-axis sharding under explicit SPMD (port of
``repro.distributed.sharding``).

The execution model of the port's mesh layer
--------------------------------------------

The JAX package runs ONE program over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives.  The port is explicit SPMD instead:

* **one process per rank.**  Each rank is a process of a
  ``torch.distributed`` group and holds plain local tensors: its block of
  every leaf (``place``).  There is no DTensor — the hand-written kernels
  take plain pointers, and DTensor has no sharding rules for them;
* **the spec tree is the layout.**  The port's counterpart of a
  ``NamedSharding`` tree is the tree of resolved specs (the tuples
  :func:`resolve_spec` returns) together with the rank's coordinates on
  the :class:`Mesh`; ``param_shardings`` in the port means that spec tree;
* **every rank runs the same host code on the same inputs** — the
  scheduler, admission, the store's reads — and the ranks stay in lockstep
  through the collectives each step makes.  Each place where GSPMD would
  reshard is an explicit collective at its call site (:func:`psum` after
  a contraction over a sharded dim, :func:`all_gather` where a consumer
  needs the whole dim), so :func:`logical_constraint` is a no-op here.

Rules, :func:`resolve_spec` (with its divisibility fallback and the rule
that no mesh axis is used twice) and :func:`tree_pspecs` are copies of the
JAX module's, so the two packages resolve every leaf alike.

A local tensor does not carry its global shape.  The model code names a
weight's logical axes at each call site (``waxes``); :class:`Layout` maps
(axes, local shape) back to the global shape and spec the placement
resolved, built once from the global base params when they are placed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import pickle
import threading
from typing import Optional, Sequence, Union

import torch
from torch.distributed import ReduceOp

Candidate = Union[str, tuple]

# ---------------------------------------------------------------------------
# rule sets (copies of the JAX module's)
# ---------------------------------------------------------------------------

# Parameters: TP on the natural axis + FSDP over data on the other axis.
PARAM_RULES = {
    "vocab": ["model"],
    "embed": ["data"],
    "ffn": ["model"],
    "ffn_small": [],          # replicated over model (tiny shared experts)
    "q_heads": ["model"],
    "kv_heads": ["model"],
    "experts": ["model"],
    "ssm": ["model"],
    "conv": [],
    "layers": [],
    # overlay-bank slot axis: replicated — every rank holds all bank slots
    # of its own weight block, so admission writes in place with no
    # collective.  Pod-local banks shard it over "pod" (BANK_RULE_POD)
    "bank": [],
}

# Pod-local overlay banks: the bank axis shards over the pod axis.
BANK_RULE_POD = ["pod"]

# Pure tensor-parallel params (serving: no FSDP; weights replicated over
# data so decode GEMVs need no weight all-gathers).
PARAM_RULES_SERVE = {**PARAM_RULES, "embed": []}


def _act_rules(seq_sharded: bool) -> dict:
    return {
        "act_batch": [] if seq_sharded else [("pod", "data"), "data"],
        "act_seq": [("pod", "data"), "data"] if seq_sharded else [],
        "act_seq_tp": ["model"],    # context-parallel attention (heads < TP)
        "act_embed": [],
        "act_heads": ["model"],
        "act_kv": ["model"],
        "act_hd": ["model"],        # fallback target when head counts don't divide
        "act_ffn": ["model"],
        "act_vocab": ["model"],
        "act_experts": ["model"],
        "act_groups": [("pod", "data"), "data"],
        "act_ssm": ["model"],
    }


ACT_RULES_TRAIN = _act_rules(seq_sharded=False)
ACT_RULES_DECODE = _act_rules(seq_sharded=False)
ACT_RULES_LONG = _act_rules(seq_sharded=True)


def rules_for(kind: str, long_context: bool = False,
              pod_banks: bool = False) -> dict:
    """(param_rules, act_rules) merged dict for a workload kind;
    "_forward_only" marks the gradient-free (serving) kinds and
    ``pod_banks`` swaps the bank rule to pod-sharded, as in the JAX
    module."""
    if kind == "train":
        return {**PARAM_RULES, **ACT_RULES_TRAIN}
    if kind in ("prefill", "decode"):
        act = ACT_RULES_LONG if long_context else ACT_RULES_DECODE
        rules = {**PARAM_RULES_SERVE, **act, "_forward_only": True}
        if pod_banks:
            rules["bank"] = BANK_RULE_POD
        return rules
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the mesh: names, shape, this rank's coordinates, one group per axis set
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) or (pod, data, model) grid of ranks, row-major:
    rank r sits at ``numpy.unravel_index(r, shape)``.  ``groups`` maps
    each non-empty tuple of axis names (in mesh order) to this rank's
    process group over the ranks that differ from it only along those axes
    (None for a group of one, or for a mesh without processes, as the
    resolution tests build); ``host_group`` is a gloo group over every
    rank, for barriers, ``share`` and the agreements (``gather``,
    ``agree_min``, ``raise_first``).  Hashable by (names, shape,
    coords)."""
    axis_names: tuple
    shape: tuple
    coords: tuple = ()
    backend: str = "gloo"
    device: torch.device = torch.device("cpu")
    groups: dict = dataclasses.field(default_factory=dict)
    host_group: object = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")
        if not self.coords:
            object.__setattr__(self, "coords", (0,) * len(self.shape))

    def _key(self) -> tuple:
        return (tuple(self.axis_names), tuple(self.shape),
                tuple(self.coords))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"coords={self.coords}, backend={self.backend})")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        r = 0
        for c, n in zip(self.coords, self.shape):
            r = r * n + c
        return r

    def axis_size(self, name: str) -> Optional[int]:
        return dict(zip(self.axis_names, self.shape)).get(name)

    def coord(self, name: str) -> int:
        return dict(zip(self.axis_names, self.coords))[name]

    def names_size(self, names) -> int:
        return math.prod(self.axis_size(n) for n in _names(names))

    def index(self, names) -> int:
        """This rank's row-major index over the axes ``names`` (the block
        it holds of a dim sharded over them)."""
        idx = 0
        for n in _names(names):
            idx = idx * self.axis_size(n) + self.coord(n)
        return idx

    def group(self, names):
        """The process group over ``names`` (None when it holds one
        rank)."""
        key = tuple(n for n in self.axis_names if n in _names(names))
        return self.groups.get(key)

    def barrier(self) -> None:
        if self.host_group is not None:
            torch.distributed.barrier(group=self.host_group)

    def share(self, obj):
        """Rank 0's ``obj`` (picklable), on every rank, over
        ``host_group``; every rank waits for rank 0 to send it."""
        if self.host_group is None:
            return obj
        box = [obj]
        torch.distributed.broadcast_object_list(box, src=0,
                                                group=self.host_group)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank,
        over ``host_group``."""
        if self.host_group is None:
            return [obj]
        out = [None] * self.size
        torch.distributed.all_gather_object(out, obj, group=self.host_group)
        return out

    def agree_min(self, values: list) -> list:
        """The element-wise MIN over the ranks of ``values`` (ints, a list
        of the same length on every rank): one all-reduce over
        ``host_group``."""
        if self.host_group is None:
            return list(values)
        t = torch.tensor(values, dtype=torch.int64)
        torch.distributed.all_reduce(t, op=ReduceOp.MIN,
                                     group=self.host_group)
        return t.tolist()

    def raise_first(self, err: Optional[BaseException]) -> None:
        """One outcome on every rank: when any rank passes an error, every
        rank raises the first failing rank's (rebuilt from its class and
        args, ``portable_error``); else nothing.  One gather over
        ``host_group``."""
        sent = self.gather(None if err is None else portable_error(err))
        for got in sent:
            if got is not None:
                cls, args = got
                raise cls(*args) from err


def portable_error(err: BaseException) -> tuple:
    """(class, args) that rebuild ``err`` on another rank; an error that
    does not pickle or rebuild travels as a RuntimeError naming it."""
    try:
        pickle.dumps((type(err), err.args))
        type(err)(*err.args)
        return type(err), err.args
    except Exception:
        return RuntimeError, (f"{type(err).__name__}: {err}",)


def build_groups(axis_names: tuple, shape: tuple, backend: str) -> dict:
    """{axis tuple: this rank's group} over an initialised world whose
    ranks are the mesh's, row-major.  ``new_group`` is collective: every
    rank creates every group, in the same order, and keeps its own."""
    dist = torch.distributed
    me = dist.get_rank()
    groups: dict = {}
    all_coords = list(itertools.product(*(range(n) for n in shape)))

    def rank_of(c):
        r = 0
        for ci, n in zip(c, shape):
            r = r * n + ci
        return r

    for k in range(1, len(axis_names) + 1):
        for combo in itertools.combinations(range(len(axis_names)), k):
            key = tuple(axis_names[i] for i in combo)
            if math.prod(shape[i] for i in combo) == 1:
                continue
            seen = set()
            for c in all_coords:
                # the group holding c: every coordinate that agrees with c
                # off the axes in ``combo``
                rest = tuple(ci for i, ci in enumerate(c) if i not in combo)
                if rest in seen:
                    continue
                seen.add(rest)
                ranks = sorted(rank_of(c2) for c2 in all_coords
                               if tuple(ci for i, ci in enumerate(c2)
                                        if i not in combo) == rest)
                g = dist.new_group(ranks, backend=backend)
                if me in ranks:
                    groups[key] = g
    return groups


def _names(part) -> tuple:
    """Mesh-axis names of one spec entry (None -> ())."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


# ---------------------------------------------------------------------------
# spec resolution with divisibility fallback (the JAX module's)
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: str) -> Optional[int]:
    if isinstance(mesh, Mesh):
        return mesh.axis_size(name)
    # a JAX-style mesh (axis_names + devices), as the fake meshes of the
    # resolution tests are
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name)


def names_size(mesh, part) -> int:
    """Ranks over the mesh axes of one spec entry (1 for None), on a
    :class:`Mesh` or a JAX-style one."""
    return math.prod(_axis_size(mesh, n) for n in _names(part))


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: dict, mesh) -> tuple:
    """Map the logical axes of one array to a spec tuple (one entry per
    dim: None, a mesh axis name, or a tuple of them)."""
    parts, used = [], set()
    for dim, ax in zip(shape, axes):
        if ax is None:
            parts.append(None)
            continue
        cands: Sequence[Candidate] = rules.get(ax, [])
        chosen = None
        for cand in cands:
            names = cand if isinstance(cand, tuple) else (cand,)
            sizes = [_axis_size(mesh, n) for n in names]
            if any(s is None for s in sizes):        # axis absent (single-pod)
                continue
            if any(n in used for n in names):
                continue
            if dim % math.prod(sizes) == 0:
                chosen = names
                used.update(names)
                break
        if chosen is None:
            parts.append(None)
        else:
            parts.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(parts)


def _map_axes(fn, axes_tree, shapes_tree):
    """Map ``fn(axes, leaf)`` over an axes tree (axis tuples are the
    leaves) with a same-structured tree of shaped leaves (anything with a
    ``.shape``: tensors, arrays, ShapeDtypeStructs; dataclass nodes such
    as OverlayEntry map field by field)."""
    if isinstance(axes_tree, tuple):      # an axes or spec tuple: a leaf
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, shapes_tree[k])
                for k, v in axes_tree.items()}
    if dataclasses.is_dataclass(axes_tree):
        return type(axes_tree)(**{
            f.name: _map_axes(fn, getattr(axes_tree, f.name),
                              getattr(shapes_tree, f.name))
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"unexpected node {type(axes_tree)} in an axes tree")


def tree_pspecs(tree_shapes, tree_axes, rules: dict, mesh):
    """Shape tree + logical-axes tree -> spec tree (mapped over the axes
    tree, as the JAX function)."""
    return _map_axes(lambda axes, x: resolve_spec(tuple(x.shape), axes,
                                                  rules, mesh),
                     tree_axes, tree_shapes)


# ---------------------------------------------------------------------------
# placement: every rank keeps its block of each leaf
# ---------------------------------------------------------------------------

def block_slices(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """This rank's block of a global ``shape`` under ``spec``: one slice
    per dim."""
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        if part is None:
            out.append(slice(None))
            continue
        n = mesh.names_size(part)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {part} ({n})")
        step = dim // n
        i = mesh.index(part)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def without_axes(spec: tuple, names) -> tuple:
    """``spec`` with the mesh axes ``names`` taken out of every entry (an
    entry left with none becomes None): the placement of a block once it
    was gathered over them."""
    drop = set(_names(names))
    out = []
    for part in spec:
        kept = tuple(n for n in _names(part) if n not in drop)
        out.append(None if not kept else kept if len(kept) > 1 else kept[0])
    return tuple(out)


def global_shape(local_shape: Sequence[int], spec: tuple,
                 mesh: Mesh) -> tuple:
    """The whole shape a block of ``local_shape`` was cut from."""
    return tuple(n * (mesh.names_size(p) if p is not None else 1)
                 for n, p in zip(local_shape,
                                 tuple(spec) + (None,) * len(local_shape)))


def block(t: torch.Tensor, spec: tuple, mesh: Mesh,
          device=None) -> torch.Tensor:
    """This rank's block of a global tensor, on ``device`` (``t``'s when
    None): a contiguous copy whenever the spec shards a dim (a view of a
    leading-dim cut would keep the whole tensor alive; a move copies the
    cut alone, with no copy on ``t``'s device first), ``t`` itself (moved)
    when it shards nothing."""
    if all(p is None for p in spec):
        return t if device is None else t.to(device)
    return t[block_slices(t.shape, spec, mesh)].to(
        device or t.device, copy=True, memory_format=torch.contiguous_format)


def place(tree, specs, mesh: Mesh, device=None):
    """Every leaf of ``tree`` cut to this rank's block under the
    same-structured spec tree ``specs`` (and moved to ``device`` when
    given; :func:`block`): the counterpart of ``jax.device_put(tree,
    shardings)``."""
    return _map_axes(lambda spec, t: block(t, spec, mesh, device), specs,
                     tree)


def unplace(tree, specs, mesh: Mesh):
    """Every leaf of ``tree`` (the rank's blocks under ``specs``) made
    whole again on every rank: the inverse of :func:`place`, one
    all-gather for each sharded dim; collective, every rank calls it."""
    def one(spec, t):
        with torch.no_grad():
            for dim, part in enumerate(spec):
                if part is not None:
                    t = all_gather(t, part, dim, mesh)
        return t
    return _map_axes(one, specs, tree)


# ---------------------------------------------------------------------------
# Layout: (logical axes, local shape) -> (global shape, spec)
# ---------------------------------------------------------------------------

class Layout:
    """What a local block alone cannot say: the global shape its placement
    cut it from.  Built from the GLOBAL params and their axes before they
    are placed; looked up by a weight's trailing logical axes (the
    ``waxes`` a call site names) and its local trailing shape.  Two leaves
    whose trailing axes and local shapes agree but whose global shapes do
    not make that key ambiguous, and a lookup of it raises."""

    def __init__(self, mesh: Mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules
        self._table: dict = {}

    @classmethod
    def from_params(cls, flat_shapes: dict, flat_axes: dict, mesh: Mesh,
                    rules: dict) -> "Layout":
        lay = cls(mesh, rules)
        for path, shape in flat_shapes.items():
            lay.add(tuple(shape), tuple(flat_axes[path]))
        return lay

    @classmethod
    def from_placed(cls, local_flat: dict, flat_specs: dict,
                    flat_axes: dict, mesh: Mesh, rules: dict) -> "Layout":
        """The layout of params already placed: each leaf's global shape
        from its block and spec."""
        return cls.from_params(
            {p: global_shape(t.shape, flat_specs[p], mesh)
             for p, t in local_flat.items()}, flat_axes, mesh, rules)

    @classmethod
    def from_specs(cls, flat_shapes: dict, flat_specs: dict,
                   flat_axes: dict, mesh: Mesh) -> "Layout":
        """The layout of leaves placed by given specs (the train step's
        weights gathered over "data": their specs without it)."""
        lay = cls(mesh, {})
        for path, shape in flat_shapes.items():
            lay.add(tuple(shape), tuple(flat_axes[path]),
                    tuple(flat_specs[path]))
        return lay

    def add(self, shape: tuple, axes: tuple, spec: tuple = None) -> None:
        if spec is None:
            spec = resolve_spec(shape, axes, self.rules, self.mesh)
        local = tuple(s // self.mesh.names_size(p) if p is not None else s
                      for s, p in zip(shape, spec))
        # keyed whole and without its leading stacked-layer dims (a call
        # site sees one layer's view); never by a shorter suffix, which
        # would let an expert stack's (ffn, embed) tail collide with a
        # dense MLP's
        lead = 0
        while lead < len(axes) and axes[lead] == "layers":
            lead += 1
        for k in {len(shape), len(shape) - lead}:
            key = (axes[-k:], local[-k:])
            val = (shape[-k:], spec[-k:])
            prev = self._table.get(key, val)
            self._table[key] = val if prev == val else None

    def lookup(self, axes: tuple, local_shape: tuple) -> tuple:
        """(global shape, spec) of a local block with trailing logical
        ``axes``; resolved on the global shape, so the spec is the one its
        placement used."""
        k = len(axes)
        key = (tuple(axes), tuple(local_shape[-k:]))
        if key not in self._table:
            raise KeyError(f"no placed leaf has axes {axes} and local shape "
                           f"{tuple(local_shape[-k:])}")
        val = self._table[key]
        if val is None:
            raise KeyError(f"axes {axes} with local shape "
                           f"{tuple(local_shape[-k:])} name leaves of "
                           "several global shapes")
        return val


# ---------------------------------------------------------------------------
# activation context (thread-local, as the JAX module's)
# ---------------------------------------------------------------------------

_ctx = threading.local()


@dataclasses.dataclass(frozen=True)
class _State:
    mesh: Mesh
    rules: dict
    layout: Optional[Layout]
    batch_axes: tuple          # mesh axes the activations' rows split over


@contextlib.contextmanager
def shard_ctx(mesh, rules: dict, layout: Optional[Layout] = None,
              batch_axes: tuple = ()):
    """Activate a mesh and rule set for the model code and the kernel
    dispatch (``kernels/dispatch.py``).  ``layout`` maps local weight
    blocks back to their placement; ``batch_axes`` names the mesh axes the
    batch rows are split over (the engine's lanes over "data")."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = _State(mesh, rules, layout, tuple(batch_axes))
    try:
        yield
    finally:
        _ctx.state = prev


def captured_ctx():
    """A context manager that re-enters the context active now (or none):
    for model code that runs again later, perhaps on another thread — a
    rematerialised layer's recompute in the backward runs on the autograd
    engine's thread, outside the ``shard_ctx`` of its forward."""
    st = _state()

    @contextlib.contextmanager
    def again():
        prev = getattr(_ctx, "state", None)
        _ctx.state = st
        try:
            yield
        finally:
            _ctx.state = prev
    return again


@contextlib.contextmanager
def rows_whole():
    """Inside an active context: the activations' rows are whole on every
    rank (a layer that all-gathered them over the batch axes, as the MoE
    layer does for its capacity groups)."""
    st = _state()
    if st is None or not st.batch_axes:
        yield
        return
    with shard_ctx(st.mesh, st.rules, st.layout, batch_axes=()):
        yield


def _state() -> Optional[_State]:
    return getattr(_ctx, "state", None)


def active_mesh() -> Optional[Mesh]:
    st = _state()
    return st.mesh if st else None


def active_rules() -> Optional[dict]:
    """Rule set of the active shard_ctx (None when inactive)."""
    st = _state()
    return st.rules if st else None


def active_layout() -> Optional[Layout]:
    st = _state()
    return st.layout if st else None


def active_batch_axes() -> tuple:
    st = _state()
    return st.batch_axes if st else ()


def ctx_axis_size(name: str) -> Optional[int]:
    """Size of a mesh axis in the active context (None when inactive or
    the axis is absent)."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return _axis_size(mesh, name)


def ctx_forward_only() -> bool:
    """True inside a serving (gradient-free) rules context."""
    st = _state()
    return bool(st and st.rules.get("_forward_only"))


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """A no-op, on purpose.  Under GSPMD a constraint asks the compiler to
    reshard; under explicit SPMD each such reshard is an explicit
    collective at its call site (``psum`` after a contraction over a
    sharded dim, ``all_gather`` where the whole dim is needed), and a
    tensor's layout is whatever its producer made."""
    return x


def local_top_k(score: torch.Tensor, k: int, axes=None) -> tuple:
    """Plain top-k over the last dim (the lower index first among equal
    values, ``lax.top_k``'s order): routing scores are replicated on every
    model rank, so there is nothing to keep shard-local."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
#
# Under grad (training) the collectives carry gradients by the explicit-SPMD
# rule of Megatron-LM's f/g pair, which keeps the gradient of a tensor that
# every rank of a group holds whole the same whole gradient on each of
# them:
#
# * ``psum`` (g): the sum is used the same way on every rank, so its
#   gradient arrives whole on each, and each partial's gradient is that
#   gradient: an identity backward;
# * ``all_gather``: the rank's own block of the gradient of the whole;
#   over the batch's axes, or with ``reduce_grad``, the ranks use the
#   whole differently (each keeps its own rows of a result, or an FSDP
#   weight serves each rank's own rows), so their gradients are summed
#   first (a reduce-scatter);
# * ``enter`` (f): where a tensor that every rank of a group holds whole
#   enters a rank's own computation (a column-parallel product, a slice of
#   the rank's heads, rows or features), an identity forward whose backward
#   sums the ranks' partial gradients.
#
# Without grad each is the plain collective (or nothing, for ``enter``)
# and builds no graph: serving is unchanged.  Backward sums run in fp32
# and round once to the gradient's dtype.


def _host_hop(mesh: Mesh, x: torch.Tensor) -> bool:
    """Under gloo a CUDA tensor crosses through the host, one copy each
    way, so the result does not depend on which collectives this build's
    gloo takes on CUDA tensors."""
    return mesh.backend == "gloo" and x.is_cuda


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, group, mesh: Mesh, op=None) -> torch.Tensor:
    """The all-reduce of ``x`` over ``group`` as a new tensor in ``x``'s
    dtype and device."""
    buf = x.detach().to("cpu", copy=True) if _host_hop(mesh, x) \
        else x.detach().clone().contiguous()
    torch.distributed.all_reduce(buf, op=ReduceOp.SUM if op is None else op,
                                 group=group)
    return buf.to(x.device)


def _sum_fp32(dy: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """A gradient summed over ``group`` in fp32, rounded once to its
    dtype."""
    return _all_reduce(dy.to(torch.float32), group, mesh).to(dy.dtype)


def _all_gather(x: torch.Tensor, group, mesh: Mesh, dim: int
                ) -> torch.Tensor:
    src = x.detach().to("cpu") if _host_hop(mesh, x) else x.detach()
    src = src.contiguous()
    n = torch.distributed.get_world_size(group)
    parts = [torch.empty_like(src) for _ in range(n)]
    torch.distributed.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _own_block(t: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    size = t.shape[dim] // mesh.names_size(axis)
    return t.narrow(dim, mesh.index(axis) * size, size)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mesh):
        return _all_reduce(x, group, mesh)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mesh, axis, dim, reduce_grad):
        ctx.args = (group, mesh, axis, dim, reduce_grad)
        return _all_gather(x, group, mesh, dim)

    @staticmethod
    def backward(ctx, dy):
        group, mesh, axis, dim, reduce_grad = ctx.args
        if reduce_grad:
            dx = _reduce_scatter(dy, group, mesh, axis, dim)
        else:
            dx = _own_block(dy, mesh, axis, dim).contiguous()
        return dx, None, None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mesh):
        ctx.args = (group, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum_fp32(dy, *ctx.args), None, None


def psum(x: torch.Tensor, axes, mesh: Optional[Mesh] = None,
         op=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the mesh axes ``axes`` (a name or a
    tuple), returned as a new tensor in ``x``'s dtype and device; ``op``
    (a :class:`ReduceOp`) takes another reduction, such as the elementwise
    MAX, exact in any order.  A group of one returns ``x``.  Under grad
    the sum's backward is the identity (the sum is used alike on every
    rank); another reduction carries no gradient."""
    mesh = mesh or active_mesh()
    group = mesh.group(axes) if mesh is not None else None
    if group is None:
        return x
    if op is None and _tracks_grad(x):
        return _PSum.apply(x, group, mesh)
    return _all_reduce(x, group, mesh, op)


def all_gather(x: torch.Tensor, axis, dim: int,
               mesh: Optional[Mesh] = None,
               reduce_grad: bool = False) -> torch.Tensor:
    """The blocks of ``x`` from every rank of the mesh axes ``axis``,
    concatenated along ``dim`` in coordinate order (the whole dim a
    placement split).  A group of one returns ``x``.  Under grad the
    backward keeps the rank's block of the gradient; with ``reduce_grad``,
    and over the axes the active context's batch rows split over (each
    rank keeps its own rows of what it computes from the whole), it sums
    the ranks' gradients first (a reduce-scatter:
    :func:`_reduce_scatter`)."""
    mesh = mesh or active_mesh()
    group = mesh.group(axis) if mesh is not None else None
    if group is None:
        return x
    if _tracks_grad(x):
        reduce_grad = reduce_grad or bool(
            set(_names(axis)) & set(active_batch_axes()))
        return _AllGather.apply(x, group, mesh, axis, dim, reduce_grad)
    return _all_gather(x, group, mesh, dim)


def enter(x: torch.Tensor, axes, mesh: Optional[Mesh] = None
          ) -> torch.Tensor:
    """``x``, which every rank of the mesh axes ``axes`` holds whole, as
    it enters a rank's own computation: the identity, whose backward sums
    the ranks' gradients over ``axes`` (Megatron-LM's f).  ``x`` itself
    without grad, off a mesh, for ``axes`` None or a group of one."""
    if axes is None or not _tracks_grad(x):
        return x
    mesh = mesh or active_mesh()
    group = mesh.group(axes) if mesh is not None else None
    if group is None:
        return x
    return _Enter.apply(x, group, mesh)


def _reduce_scatter(x: torch.Tensor, group, mesh: Mesh, axis,
                    dim: int) -> torch.Tensor:
    """The fp32 sum of ``x`` over ``group``, the rank's block of ``dim``
    kept, in ``x``'s dtype.  NCCL reduce-scatters; gloo, which lacks a
    reduce-scatter in some builds, all-reduces and keeps the block."""
    xf = x.detach().to(torch.float32)
    if mesh.backend == "nccl":
        src = xf.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // mesh.names_size(axis),)
                            + tuple(src.shape[1:]))
        torch.distributed.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous().to(x.dtype)
    return _own_block(_all_reduce(xf, group, mesh), mesh, axis,
                      dim).contiguous().to(x.dtype)
