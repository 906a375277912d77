"""Mixture-of-Experts (port of ``repro.models.moe``): fine-grained routed
experts plus shared experts, with group-limited capacity dispatch.

1. tokens are reshaped to (G, N, D) groups (``_group_tokens``);
2. each token picks its ``top_k`` experts from a softmax over the router's
   logits, and each (group, expert) keeps its top ``C`` tokens by gate
   score, ``C = N·top_k/E·capacity_factor``: static shapes, and tokens past
   an expert's capacity are dropped;
3. the kept tokens are gathered to (G, E, C, D), run through the expert
   stacks (gated SwiGLU, one grouped GEMM per projection) and summed
   back, weighted by their gate scores.

With a delta overlay on the expert stacks each grouped GEMM is one launch
of the expert-stacked fused delta GEMM
(``kernels/ops.bitlinear_axes_stacked``), where the JAX module vmaps its
kernel over the expert axis.  A BANKED overlay (``vidx`` per batch row)
routes every token by its own variant's router and runs the expert pass
once per bank slot with the other rows zeroed, as the JAX module does.

On a mesh (``distributed/sharding.py``) the experts shard over "model":
the router's block of scores is all-gathered so routing is whole and the
same on every rank, each rank runs the stacked GEMMs of its own experts
(``kernels/dispatch``), sums the routed contributions of those experts and
the ranks all-reduce that sum.  The shared experts are replicated and
added after the all-reduce, so they count once.  Capacity groups span the
whole batch, as in the JAX program: when the engine splits its lanes over
"data" and a group would cross the split, the layer all-gathers its rows
first and keeps its own rows of the result.

Under pod-local banks (the lanes split pod-major over ("pod", "data"),
each rank holding its pod's bank slots, the lanes' ids translated to
them) the gathered rows carry ids of several pods' banks, and pod 1's id
1 names another variant than pod 0's.  So each rank computes the router
scores of its own rows from its pod's router slots, and the ranks
all-gather the scores with the rows: routing, capacity selection and the
aux loss run on the whole batch, as JAX routes it over the global bank.
The banked expert passes then run on the rows of the rank's pod alone
(the other pods' rows carry an id no slot matches, so they enter as zero
rows), and the shared experts read those rows as the base slot; the rank
keeps its own rows, which lie in its pod.  No id reaches a bank that does
not hold it, and the layer computes what the global bank computes for the
same lanes (its tokens depend on the lanes' layout, which the affinity
router decides: a capacity group is the whole batch).

Under grad (training under a mesh, ``sharding.rules_for("train")``) the
whole scores and rows enter the rank's experts through ``sharding.enter``
and the combine's sum has an identity backward.  A rank's rows of the
batch give its share of the aux loss (the batch's token fractions times
its rows' probabilities over the batch's count), and where a capacity
group crosses the data split every rank computes the whole batch's loss
and counts it 1/data, since the ranks' gradients are summed over "data".

Ties: ``lax.top_k`` returns the lower index first among equal values
(unrouted tokens all score 0 in the capacity selection); ``top_k`` here
takes a stable descending sort, which orders ties the same way, where
``torch.topk`` promises no order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import is_quant
from repro_torch.models.delta_overlay import entry_slot, oget
from repro_torch.models.layers import mlp_apply
from repro_torch.models.param import dense_init

EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def moe_init(gen: torch.Generator, cfg) -> dict:
    d, e_ff, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (e, d), ("experts", "embed"), scale=0.02),
        "w_gate": dense_init(gen, (e, e_ff, d), ("experts", "ffn", "embed")),
        "w_up": dense_init(gen, (e, e_ff, d), ("experts", "ffn", "embed")),
        "w_down": dense_init(gen, (e, d, e_ff), ("experts", "embed", "ffn")),
    }
    if cfg.num_shared_experts:
        sh_ff = cfg.expert_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (sh_ff, d), ("ffn_small", "embed")),
            "w_up": dense_init(gen, (sh_ff, d), ("ffn_small", "embed")),
            "w_down": dense_init(gen, (d, sh_ff), ("embed", "ffn_small")),
        }
    return p


def _group_tokens(x: torch.Tensor, target_group: int = 4096
                  ) -> tuple[torch.Tensor, tuple]:
    """(B, S, D) -> (G, N, D), N the largest divisor of B·S up to
    ``target_group``."""
    b, s, d = x.shape
    t = b * s
    n = min(target_group, t)
    while t % n:
        n -= 1
    return x.reshape(t // n, n, d), (b, s, d)


def top_k(score: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last dim,
    descending, the lower index first among equal values (``lax.top_k``'s
    order; ``sharding.local_top_k``: scores are whole on every rank)."""
    from repro_torch.distributed.sharding import local_top_k
    return local_top_k(score, k)


def capacity(n: int, cfg) -> int:
    """Rows each expert keeps from a group of ``n`` tokens:
    ``N·top_k/E·capacity_factor``, at least 1 and at most ``n``."""
    return min(max(1, int(n * cfg.top_k / cfg.num_experts
                          * cfg.capacity_factor)), n)


def _combine(yd: torch.Tensor, c_idx: torch.Tensor, top_idx: torch.Tensor,
             e_lo: int = 0) -> torch.Tensor:
    """Weighted expert outputs yd (G, E, C, D) back to token order
    (G, N, D): each token gathers the slots it holds in its top-k experts'
    lists and sums them in one reduction, accumulating in at least fp32
    (the result is left in that dtype).
    The JAX module scatter-adds; on CUDA a scatter-add sums with atomics in
    no fixed order, so a repeat run could differ in the last bit.  A token
    an expert dropped reads a zero slot; a list's zero-score filler tokens
    do not have that expert in their top-k, so their slots are never
    read.  With ``e_lo`` the E experts of ``yd`` are global experts
    e_lo..e_lo+E-1 (a rank's local experts) and a token's other experts
    read the zero slot."""
    g, e, cap, d = yd.shape
    n = top_idx.shape[1]
    # slot_of[g, e, t] = token t's slot in expert e's list, else cap
    slot_of = torch.full((g, e, n), cap, dtype=torch.int64,
                         device=yd.device)
    slot_of.scatter_(2, c_idx, torch.arange(cap, device=yd.device).expand(
        g, e, cap))
    local = top_idx - e_lo
    mine = (local >= 0) & (local < e)
    local = local.clamp(0, e - 1)
    pos = slot_of.transpose(1, 2).gather(2, local)              # (G,N,k)
    pos = torch.where(mine, pos, torch.full_like(pos, cap))
    yd_pad = torch.cat([yd, yd.new_zeros((g, e, 1, d))], dim=2)
    g_idx = torch.arange(g, device=yd.device)[:, None, None]
    acc = torch.promote_types(yd.dtype, torch.float32)
    return yd_pad[g_idx, local, pos].sum(dim=2, dtype=acc)


def _local_experts(w) -> tuple:
    """(first global expert, mesh axes) of the rank's expert block on the
    active mesh; (0, None) when every rank holds every expert."""
    from repro_torch.distributed import sharding as S
    lay = S.active_layout()
    if lay is None:
        return 0, None
    wq = w.q if is_quant(w) else w
    _, (ep, _, _) = lay.lookup(("experts", "ffn", "embed"),
                               tuple(wq.shape[-3:]))
    if ep is None:
        return 0, None
    return S.active_mesh().index(ep) * wq.shape[-3], ep


def _whole_groups(t_local: int, ways: int) -> bool:
    """Whether the capacity groups of ``ways`` × ``t_local`` tokens (the
    JAX program groups the whole batch) each lie inside one rank's rows."""
    t = t_local * ways
    n = min(4096, t)
    while t % n:
        n -= 1
    return t_local % n == 0


def _expert_mm(xe: torch.Tensor, w, ent,
               waxes=("experts", "ffn", "embed")) -> torch.Tensor:
    """Per-expert matmul xe (E, M, D) · w (E, F, D) -> (E, M, F).  With a
    delta-overlay entry stacked over the experts the whole stack is one
    launch of the fused delta GEMM against the base weights; an int8 base
    without an entry factors its per-channel scale out of the product (out
    of the ranks' sum, when the contracted dim is sharded)."""
    if ent is None:
        if is_quant(w):
            return (_plain_stack("emd,efd->emf", xe, w.q, xe.dtype, waxes)
                    * w.scale.to(xe.dtype)[:, None, :])
        return _plain_stack("emd,efd->emf", xe, w, xe.dtype, waxes)
    from repro_torch.kernels import ops as K
    return K.bitlinear_axes_stacked(xe, ent.packed, ent.v_row, ent.v_col, w,
                                    waxes)


def _experts(p: dict, xe: torch.Tensor, ents: dict) -> torch.Tensor:
    """Gated SwiGLU over the expert stacks: xe (E, M, D) -> (E, M, D)."""
    h = (F.silu(_expert_mm(xe, p["w_gate"], ents["w_gate"]))
         * _expert_mm(xe, p["w_up"], ents["w_up"]))
    return _expert_mm(h, p["w_down"], ents["w_down"],
                      waxes=("experts", "embed", "ffn"))


def _stack_parts(w, waxes) -> tuple:
    """(out part, contracted part): the mesh axes that shard an expert
    stack's out and contracted dims (experts that do not divide the model
    axis leave it to the ffn dim), (None, None) off a mesh."""
    from repro_torch.distributed import sharding as S
    lay = S.active_layout()
    if lay is None:
        return None, None
    return lay.lookup(tuple(waxes), tuple(w.shape[-3:]))[1][1:]


def _plain_stack(eq: str, xop: torch.Tensor, w, dtype, waxes):
    """A plain product over an fp expert stack (or an int8 one's payload,
    whose caller applies the scale after it); a partial contraction (see
    ``_stack_parts``) stays fp32 until the ranks' sum.  Under grad the
    input of a stack whose out dim is sharded enters the rank's block
    (``sharding.enter``)."""
    from repro_torch.distributed import sharding as S
    op, dp = _stack_parts(w, waxes)
    if dp is None:
        return torch.einsum(eq, S.enter(xop, op), w.to(dtype))
    y = torch.einsum(eq, xop.to(torch.float32),
                     w.to(dtype).to(torch.float32))
    return S.psum(y, dp).to(dtype)


def _emm(eq: str, xop: torch.Tensor, w, dtype,
         waxes=("experts", "ffn", "embed")) -> torch.Tensor:
    """Grouped product over a possibly int8 expert stack: its scale (E, F)
    broadcasts onto the (G, E, C, F) output, an exact factoring."""
    if is_quant(w):
        return (_plain_stack(eq, xop, w.q, dtype, waxes)
                * w.scale.to(dtype)[None, :, None, :])
    return _plain_stack(eq, xop, w, dtype, waxes)


def moe_apply(p: dict, x: torch.Tensor, cfg, ov=None, vidx=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), Switch aux loss (fp32 scalar)).

    ``vidx`` (B,) serves a mixed-variant batch over a BANKED overlay: the
    router (an uncompressed extra) is applied per token by a masked select
    over the bank slots, and the expert pass runs once per slot with the
    rows of other slots zeroed.  Capacity dispatch couples rows: a token's
    survival depends on the other tokens of its group."""
    from repro_torch.distributed import sharding as S
    rows = S.active_batch_axes()
    if rows:
        mesh = S.active_mesh()
        ways = mesh.names_size(rows)
        if not _whole_groups(x.shape[0] * x.shape[1], ways):
            # a capacity group crosses the lanes' split: route the whole
            # batch on every rank and keep this rank's rows
            b = x.shape[0]
            i = mesh.index(rows)
            # each rank keeps its own rows of the result: under grad the
            # ranks' gradients of the gathered rows are summed (a gather
            # over the batch's axes reduce-scatters its gradient)
            xw = S.all_gather(x, rows, 0)
            vw = None if vidx is None else S.all_gather(vidx, rows, 0)
            logits = None
            pod = None if vidx is None else _pod_rows(mesh, rows, b)
            if pod is not None:
                # pod-local ids: the scores of the rank's own rows from its
                # pod's router, whole over the rows; the other pods' rows
                # leave the banked passes
                logits = S.all_gather(_router_logits(p, x, ov, vidx), rows,
                                      0)
                keep = torch.zeros_like(vw, dtype=torch.bool)
                keep[pod] = True
                vw = torch.where(keep, vw, torch.full_like(vw, -1))
            with S.rows_whole():
                y, aux = _moe(p, xw, cfg, ov, vw, logits)
            if not S.ctx_forward_only():
                # training: every rank of the rows computed the whole
                # batch's aux loss, and the gradients of the ranks' shares
                # are summed over them; count it once
                aux = aux / ways
            return y[i * b:(i + 1) * b].contiguous(), aux
    return _moe(p, x, cfg, ov, vidx)


def _pod_rows(mesh, rows, b: int):
    """The slice of the gathered rows that belong to the rank's pod when
    the bank is pod-local, else None (the ids are those of one bank).
    The lanes then split pod-major over ("pod", "data"), ``act_batch``'s
    rule that the engine requires, so a pod's rows are contiguous."""
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels.dispatch import _bank_part
    if _bank_part(mesh, S.active_rules()) is None:
        return None
    per_pod = mesh.names_size(rows) // mesh.axis_size("pod") * b
    first = mesh.coord("pod") * per_pod
    return slice(first, first + per_pod)


def _router_logits(p: dict, x: torch.Tensor, ov, vidx) -> torch.Tensor:
    """The router's fp32 scores (..., E) of tokens x (..., D), whole over
    the experts.  With a banked router and ``vidx`` (broadcast to x's
    leading dims) each token keeps its own variant's scores, the same
    product per bank slot by a masked select (slot 0 = base)."""
    from repro_torch.distributed import sharding as S
    rb = oget(ov, "router")
    _, e_part = _local_experts(p["w_gate"])
    if rb is None or vidx is None:
        # the router's rows shard like the stacks' experts: x enters the
        # rank's block of the scores
        logits = (S.enter(x, e_part) @ p["router"].T.to(x.dtype)).to(
            torch.float32)
    else:
        vidx = vidx.reshape(vidx.shape + (1,) * (x.dim() - 1 - vidx.dim()))
        logits = x @ rb[0].T.to(x.dtype)
        for vi in range(1, rb.shape[0]):
            logits = torch.where((vidx == vi)[..., None],
                                 x @ rb[vi].T.to(x.dtype), logits)
        logits = logits.to(torch.float32)
    if e_part is not None:
        # the router shards its experts like the stacks: whole scores on
        # every rank, so routing is the same everywhere
        logits = S.all_gather(logits, e_part, logits.dim() - 1)
    return logits


def _moe(p: dict, x: torch.Tensor, cfg, ov, vidx, logits=None):
    """The layer on rows that hold whole capacity groups.  ``logits``
    (B, S, E): the router's scores when the caller computed them (pod-local
    banks); ``vidx``'s rows of other pods then carry -1, which no expert
    slot matches, and the shared experts read them as the base slot."""
    from repro_torch.distributed import sharding as S
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    xg, orig = _group_tokens(x)
    g, n, d = xg.shape
    cap = capacity(n, cfg)
    # per-token variant indices in group layout (tokens are row-major)
    vidx_gn = (None if vidx is None
               else vidx[:, None].expand(b, s).reshape(g, n))
    # this rank's experts (all of them off a mesh)
    e_lo, e_part = _local_experts(p["w_gate"])
    e_l = p["w_gate"].shape[-3] if not is_quant(p["w_gate"]) \
        else p["w_gate"].q.shape[-3]

    shared_vidx = vidx_gn
    if logits is None:
        logits = _router_logits(p, xg, ov, vidx_gn)             # (G,N,E)
    else:
        logits = logits.reshape(g, n, e)
        shared_vidx = vidx_gn.clamp(min=0)
    probs = torch.softmax(logits, dim=-1)
    top_val, top_idx = top_k(probs, k)
    top_val = top_val / torch.clamp(top_val.sum(-1, keepdim=True), min=1e-9)

    # score[g, e, n] = the token's normalised gate if e is in its top-k
    sel = F.one_hot(top_idx, e).to(torch.float32) * top_val[..., None]
    score = sel.sum(dim=2).transpose(1, 2)                      # (G,E,N)
    c_val, c_idx = top_k(score, cap)                            # (G,E,C)
    # the rank's experts' lists (the scores and rows, whole on every rank,
    # enter the rank's own experts)
    c_val = S.enter(c_val, e_part)[:, e_lo:e_lo + e_l]
    c_idx = c_idx[:, e_lo:e_lo + e_l]
    g_idx = torch.arange(g, device=x.device)[:, None, None]
    xd = S.enter(xg, e_part)[g_idx, c_idx]                      # (G,E,C,D)

    ents = {key: oget(ov, key) for key in EXPERT_KEYS}
    has_delta = any(v is not None for v in ents.values())
    if has_delta:
        # expert-major (E, G·C, ·): one stacked GEMM per projection.  The
        # capacity fillers (c_val 0) enter as zero rows: their outputs are
        # discarded below, and an expert that no token routes to then
        # costs the kernel no weight read.
        routed = (c_val > 0).transpose(0, 1).reshape(e_l, g * cap, 1)
        xe = torch.where(routed,
                         xd.transpose(0, 1).reshape(e_l, g * cap, d),
                         torch.zeros((), dtype=xd.dtype, device=xd.device))
        if vidx_gn is None:
            ye = _experts(p, xe, ents)
        else:
            vidx_e = vidx_gn[g_idx, c_idx].transpose(0, 1).reshape(
                e_l, g * cap)
            nbank = next(v.packed.shape[0] for v in ents.values()
                         if v is not None)
            ye = torch.zeros((e_l, g * cap, d), dtype=x.dtype,
                             device=x.device)
            for vi in range(nbank):
                mask = (vidx_e == vi)[..., None]
                xv = torch.where(mask, xe, torch.zeros((), dtype=xe.dtype,
                                                       device=xe.device))
                yv = _experts(p, xv, {key: entry_slot(v, vi)
                                      for key, v in ents.items()})
                ye = torch.where(mask, yv, ye)
        yd = ye.reshape(e_l, g, cap, d).transpose(0, 1)
    else:
        h = (F.silu(_emm("gecd,efd->gecf", xd, p["w_gate"], x.dtype))
             * _emm("gecd,efd->gecf", xd, p["w_up"], x.dtype))
        yd = _emm("gecf,edf->gecd", h, p["w_down"], x.dtype,
                  waxes=("experts", "embed", "ffn"))
    yd = yd * c_val[..., None].to(x.dtype)           # combine weight
    # capacity slots that hold zero-score (unrouted) tokens add nothing
    yd = torch.where((c_val > 0)[..., None], yd,
                     torch.zeros((), dtype=yd.dtype, device=yd.device))

    y = _combine(yd, c_idx, top_idx, e_lo)
    if e_part is not None:
        # each rank summed its own experts' contributions
        y = S.psum(y, e_part)
    y = y.to(yd.dtype)

    if "shared" in p:
        # replicated on every rank: added once, after the all-reduce
        y = y + mlp_apply(p["shared"], xg, ov=oget(ov, "shared"),
                          vidx=shared_vidx, ffn_ax="ffn_small")

    # Switch-style load-balancing loss: E · Σ_e f_e · P_e
    rows = S.active_batch_axes()
    if rows and not S.ctx_forward_only():
        # training on the rank's rows of the batch (its groups whole): the
        # batch's token fractions f (no gradient) and this rank's share of
        # the batch's mean probabilities P, so the ranks' shares sum to
        # the batch's loss
        n_all = g * n * S.active_mesh().names_size(rows)
        frac_tokens = S.psum(F.one_hot(top_idx, e).to(torch.float32).sum(
            dim=(0, 1, 2)).detach(), rows) / (n_all * k)
        frac_probs = probs.sum(dim=(0, 1)) / n_all
    else:
        frac_tokens = F.one_hot(top_idx, e).to(torch.float32).sum(2).mean(
            dim=(0, 1)) / k
        frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(orig), aux.to(torch.float32)
