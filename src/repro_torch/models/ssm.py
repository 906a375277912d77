"""SSM / recurrent sequence-mixing primitives (port of
``repro.models.ssm``).

Three cell families, each with a *chunkwise-parallel* sequence form and a
*recurrent* single-step form (the decode path):

* mLSTM (xLSTM): matrix memory C ∈ R^(hd×hd), exponential input gate,
  sigmoid forget gate, max-stabilizer m.  The chunkwise form is exactly
  equivalent to the recurrence (the stabilizer cancels in the output).
* sLSTM (xLSTM): scalar memory with a hidden-state recurrence (R·h_{t-1}
  feeds the gates): sequential, a Python loop over time where the JAX
  module ``lax.scan``s.
* Mamba2 (SSD): scalar-decay state S ∈ R^(P×N) per head; chunkwise SSD
  with causal decay matrices, no stabilizer needed (log dA ≤ 0).

Sequence layout: (B, S, H, ·); states carry (B, H, ·).  Internal math is
fp32 and outputs are cast back to the input dtype, as in the JAX module;
where the JAX module ``lax.scan``s over chunks the port loops over them.
Nothing here updates a tensor in place, so the sequence forms are
differentiable (``core/calibration.e2e_calibrate``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def _pick_chunk(s: int, target: int = 256) -> int:
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _causal(c: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((c, c), dtype=torch.bool, device=device))


def _masked_exp(x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """exp(x) where ``causal`` holds, 0 elsewhere, masked in the exponent:
    above the diagonal a chunk's decay exponent grows with the distance
    and overflows fp32 past a few hundred steps (a 256-step chunk of
    forget gates at init), and exp's backward multiplies the masked 0
    gradient by that inf, which is NaN.  The values are the same as
    masking after the exp."""
    return torch.exp(torch.where(causal, x, torch.full(
        (), float("-inf"), dtype=x.dtype, device=x.device)))


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init_state(b: int, h: int, hd: int, device) -> dict:
    return {
        "C": torch.zeros((b, h, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((b, h, hd), dtype=F32, device=device),
        "m": torch.zeros((b, h), dtype=F32, device=device),
    }


def mlstm_step(state: dict, q, k, v, i_gate, f_gate) -> tuple[dict,
                                                               torch.Tensor]:
    """One recurrent step.  q,k,v: (B,H,hd); gates: (B,H) pre-activations."""
    qf = q.to(F32) * (q.shape[-1] ** -0.5)
    kf, vf = k.to(F32), v.to(F32)
    lf = F.logsigmoid(f_gate.to(F32))
    li = i_gate.to(F32)
    m_new = torch.maximum(lf + state["m"], li)
    f_act = torch.exp(lf + state["m"] - m_new)[..., None]
    i_act = torch.exp(li - m_new)[..., None]
    C = f_act[..., None] * state["C"] + i_act[..., None] * (
        kf[..., :, None] * vf[..., None, :])
    n = f_act * state["n"] + i_act * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, qf))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    h_out = (num / den).to(q.dtype)
    return {"C": C, "n": n, "m": m_new}, h_out


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state: dict | None = None,
                    chunk: int = 256) -> tuple[torch.Tensor, dict]:
    """Parallel chunkwise mLSTM over a full sequence.

    q,k,v: (B,S,H,hd); gates: (B,S,H).  Returns (h (B,S,H,hd), final
    state)."""
    b, s, h, hd = q.shape
    c = _pick_chunk(s, chunk)
    if state is None:
        state = mlstm_init_state(b, h, hd, q.device)
    qf = q.to(F32) * hd ** -0.5
    kf, vf = k.to(F32), v.to(F32)
    li_all = i_gate.to(F32)
    lf_all = F.logsigmoid(f_gate.to(F32))
    causal = _causal(c, q.device)[None, :, :, None]
    C_p, n_p, m_p = state["C"], state["n"], state["m"]
    hs = []
    for t0 in range(0, s, c):
        qc, kc, vc = qf[:, t0:t0 + c], kf[:, t0:t0 + c], vf[:, t0:t0 + c]
        lic, lfc = li_all[:, t0:t0 + c], lf_all[:, t0:t0 + c]
        bcum = torch.cumsum(lfc, dim=1)                   # (B,c,H) inclusive
        a = lic - bcum                                    # a_s = ĩ_s − b_s
        rm = torch.maximum(m_p[:, None, :],
                           torch.cummax(a, dim=1).values)  # (B,c,H)
        # intra-chunk decay D_{is} = exp(a_s − rm_i), s ≤ i
        dmat = _masked_exp(a[:, None, :, :] - rm[:, :, None, :],
                           causal)                               # (B,i,s,H)
        scores = torch.einsum("bihd,bshd->bish", qc, kc)         # (B,i,s,H)
        w = scores * dmat
        o_intra = torch.einsum("bish,bshd->bihd", w, vc)
        nd_intra = torch.sum(w, dim=2)                           # (B,i,H)
        # inter-chunk (carry) contribution
        g = torch.exp(m_p[:, None, :] - rm)                      # (B,i,H)
        o_inter = g[..., None] * torch.einsum("bhkv,bihk->bihv", C_p, qc)
        nd_inter = g * torch.einsum("bhk,bihk->bih", n_p, qc)
        m_i = bcum + rm
        num = o_intra + o_inter
        den = torch.maximum(torch.abs(nd_intra + nd_inter), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # carry: m_next = b_tot + max(m_p, max_s a_s),
        # C_next = exp(b_tot + m_p − m_next)·C_p
        #        + Σ_s exp(b_tot − b_s + ĩ_s − m_next)·k_s v_sᵀ
        b_tot = bcum[:, -1, :]                                   # (B,H)
        m_new = b_tot + rm[:, -1, :]
        decay_carry = torch.exp(b_tot + m_p - m_new)             # (B,H)
        kv_w = torch.exp((b_tot[:, None, :] - bcum + lic) - m_new[:, None, :])
        C_p = decay_carry[..., None, None] * C_p + torch.einsum(
            "bsh,bshk,bshv->bhkv", kv_w, kc, vc)
        n_p = decay_carry[..., None] * n_p + torch.einsum(
            "bsh,bshk->bhk", kv_w, kc)
        m_p = m_new
    h_out = torch.cat(hs, dim=1).to(q.dtype)
    return h_out, {"C": C_p, "n": n_p, "m": m_p}


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init_state(b: int, h: int, hd: int, device) -> dict:
    return {
        "c": torch.zeros((b, h, hd), dtype=F32, device=device),
        "n": torch.ones((b, h, hd), dtype=F32, device=device),
        "h": torch.zeros((b, h, hd), dtype=F32, device=device),
        "m": torch.zeros((b, h, hd), dtype=F32, device=device),
    }


def slstm_step(state: dict, zx, ix, fx, ox, r_z, r_i, r_f, r_o
               ) -> tuple[dict, torch.Tensor]:
    """One sLSTM step with per-head recurrent weights.

    zx/ix/fx/ox: (B,H,hd) input-projected pre-activations; r_*: (H, hd, hd)
    block-diagonal recurrent weights acting on h_{t-1}, or (B, H, hd, hd)
    per row (banked mixed-variant serving).  A recurrent weight held in
    another dtype (an fp16 fine-tuned extra) meets the fp32 state in
    fp32, as JAX's type promotion has it."""
    hp = state["h"]

    def rec(r):
        r = r.to(hp.dtype)
        if r.dim() == 4:
            return torch.einsum("bhd,bhde->bhe", hp, r)
        return torch.einsum("bhd,hde->bhe", hp, r)
    z = torch.tanh(zx.to(F32) + rec(r_z))
    li = ix.to(F32) + rec(r_i)
    lf = F.logsigmoid(fx.to(F32) + rec(r_f))
    o = torch.sigmoid(ox.to(F32) + rec(r_o))
    m_new = torch.maximum(lf + state["m"], li)
    f_act = torch.exp(lf + state["m"] - m_new)
    i_act = torch.exp(li - m_new)
    c = f_act * state["c"] + i_act * z
    n = f_act * state["n"] + i_act
    h_new = o * (c / torch.clamp_min(n, 1e-6))
    return {"c": c, "n": n, "h": h_new, "m": m_new}, h_new


def slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o, state: dict | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Sequential sLSTM over (B,S,H,hd) pre-activations."""
    b, s, h, hd = zx.shape
    if state is None:
        state = slstm_init_state(b, h, hd, zx.device)
    hs = []
    for t in range(s):
        state, h_t = slstm_step(state, zx[:, t], ix[:, t], fx[:, t],
                                ox[:, t], r_z, r_i, r_f, r_o)
        hs.append(h_t)
    return torch.stack(hs, dim=1).to(zx.dtype), state


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def mamba_init_state(b: int, h: int, p: int, n: int, device) -> torch.Tensor:
    return torch.zeros((b, h, p, n), dtype=F32, device=device)


def mamba_step(state: torch.Tensor, x, bm, cm, dt, a_log, d_skip
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD step.  x: (B,H,P); bm/cm: (B,N); dt: (B,H); a_log (H,) or
    (B,H), d_skip (H,) or (B,H) (banked per-row)."""
    xf = x.to(F32)
    a = -torch.exp(a_log.to(F32))                        # (H,)|(B,H) neg
    da = torch.exp(dt.to(F32) * a)                       # (B,H)
    upd = dt.to(F32)[..., None, None] * (
        xf[..., :, None] * bm.to(F32)[:, None, None, :])
    s_new = da[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, cm.to(F32))
    ds = d_skip.to(F32)
    y = y + (ds[None, :, None] if ds.dim() == 1 else ds[:, :, None]) * xf
    return s_new, y.to(x.dtype)


def mamba_chunkwise(x, bm, cm, dt, a_log, d_skip,
                    state: torch.Tensor | None = None, chunk: int = 128
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel SSD.

    x: (B,S,H,P); bm/cm: (B,S,N) (a single B/C group shared over heads);
    dt: (B,S,H) post-softplus; a_log/d_skip: (H,) or (B,H) per row (banked
    mixed-variant serving).  Returns (y (B,S,H,P), final state (B,H,P,N)).

    As in the JAX module, the intra-chunk operands and the (B,c,c,H)
    matrix M are rounded to the input dtype (``lp``: bf16 when serving)
    and their products accumulate in fp32 (JAX's
    ``preferred_element_type``): here each operand is rounded to ``lp``,
    upcast and contracted in fp32."""
    b, s, h, p = x.shape
    c = _pick_chunk(s, chunk)
    if state is None:
        state = mamba_init_state(b, h, p, bm.shape[-1], x.device)
    lp = x.dtype

    def low(t):
        return t.to(lp).to(F32)

    a = -torch.exp(a_log.to(F32))                        # (H,)|(B,H)
    a_c = a[None, :] if a.dim() == 1 else a[:, None, :]  # vs dtk (B,c,H)
    ds = d_skip.to(F32)
    ds_c = ds[None, None, :, None] if ds.dim() == 1 else ds[:, None, :, None]
    xf, bf, cf, dtf = x.to(F32), bm.to(F32), cm.to(F32), dt.to(F32)
    causal = _causal(c, x.device)[None, :, :, None]
    s_p = state
    ys = []
    for t0 in range(0, s, c):
        xk, bk = xf[:, t0:t0 + c], bf[:, t0:t0 + c]
        ck, dtk = cf[:, t0:t0 + c], dtf[:, t0:t0 + c]
        ldak = dtk * a_c                                 # (B,c,H) log dA ≤ 0
        lcum = torch.cumsum(ldak, dim=1)                 # inclusive
        # intra: M_{is} = (C_i·B_s)·exp(L_i − L_s)·dt_s for s ≤ i
        cb = torch.einsum("bin,bsn->bis", low(ck), low(bk))          # (B,i,s)
        decay = _masked_exp(lcum[:, :, None, :] - lcum[:, None, :, :],
                            causal)                              # (B,i,s,H)
        m = low(cb[..., None] * decay * dtk[:, None, :, :])
        y = torch.einsum("bish,bshp->bihp", m, low(xk))
        # inter: exp(L_i)·C_i·S_prev
        y = y + torch.exp(lcum)[..., None] * torch.einsum(
            "bhpn,bin->bihp", s_p, ck)
        ys.append(y + ds_c * xk)
        # carry: S_next = exp(L_c)·S_prev + Σ_s exp(L_c − L_s)·dt_s·x_s ⊗ B_s
        l_tot = lcum[:, -1, :]                           # (B,H)
        w = torch.exp(l_tot[:, None, :] - lcum) * dtk    # (B,s,H)
        s_p = torch.exp(l_tot)[..., None, None] * s_p + torch.einsum(
            "bsh,bshp,bsn->bhpn", w, xk, bk)
    return torch.cat(ys, dim=1).to(x.dtype), s_p
