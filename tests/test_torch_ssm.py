"""Port parity for the recurrent cells (``repro_torch.models.ssm`` against
``repro.models.ssm``) on numpy-seeded inputs.

Bounds, and why:

* fp32 cells (mLSTM, sLSTM, Mamba2 SSD; chunkwise and step forms) within
  1e-5 of the largest |value| of the compared tensor (and at least 1e-5
  absolute): the same fp32 arithmetic, summed in each library's own
  order, on outputs and states that reach ~10-100;
* ``mamba_chunkwise`` at bf16 inputs within 2e-2 absolute of JAX (both
  round their outputs to bf16, and here they agree bit for bit; outputs
  reach ~400, where one bf16 step is 2): the port rounds the intra-chunk
  operands to bf16 as JAX does, and the same function with that rounding
  dropped lands at least 0.25 away, so the test fails if it goes;
* the chunkwise forms at a 256-step chunk, output and gradients, within
  2e-4 of the largest |value| of the same function in float64: the long
  chunk's own fp32 error reaches 6.7e-5 of it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

B, H = 2, 3


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the largest |value| of ``want`` (at least
    ``rel`` absolute), leaf by leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], rel)
        return
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def test_pick_chunk_matches_jax():
    for s in (1, 16, 20, 24, 37, 128, 300, 1000):
        for target in (16, 128, 256):
            assert S._pick_chunk(s, target) == JS._pick_chunk(s, target)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(seed, s, hd=8):
    q, k, v, ig, fg = _arrays(seed, (B, s, H, hd), (B, s, H, hd),
                              (B, s, H, hd), (B, s, H), (B, s, H))
    return q, k, v, 2.0 * ig, fg + 1.0


@pytest.mark.parametrize("s,chunk", [(40, 20), (32, 16), (20, 256)])
def test_mlstm_chunkwise_with_state_continuation(s, chunk):
    """Two sequence halves, the second from the first's final state, at
    chunks of 20 and 16 (and one chunk): outputs and states within 1e-5."""
    arrs = _mlstm_inputs(s, s)
    (jq, jk, jv, ji, jf), (q, k, v, i, f) = _both(arrs)
    half = s // 2
    jh1, jst = JS.mlstm_chunkwise(jq[:, :half], jk[:, :half], jv[:, :half],
                                  ji[:, :half], jf[:, :half], chunk=chunk)
    jh2, jst = JS.mlstm_chunkwise(jq[:, half:], jk[:, half:], jv[:, half:],
                                  ji[:, half:], jf[:, half:], state=jst,
                                  chunk=chunk)
    h1, st = S.mlstm_chunkwise(q[:, :half], k[:, :half], v[:, :half],
                               i[:, :half], f[:, :half], chunk=chunk)
    h2, st = S.mlstm_chunkwise(q[:, half:], k[:, half:], v[:, half:],
                               i[:, half:], f[:, half:], state=st,
                               chunk=chunk)
    _close(h1, jh1)
    _close(h2, jh2)
    _close(st, jst)


def test_mlstm_step_matches_jax_and_the_chunkwise_form():
    """Eight recurrent steps from a carried state within 1e-5 of JAX's;
    the step recurrence and the chunkwise form agree (the stabilizer
    cancels)."""
    arrs = _mlstm_inputs(7, 8)
    (jq, jk, jv, ji, jf), (q, k, v, i, f) = _both(arrs)
    jst = JS.mlstm_init_state(B, H, 8)
    st = S.mlstm_init_state(B, H, 8, "cpu")
    hs = []
    for t in range(8):
        jst, jh = JS.mlstm_step(jst, jq[:, t], jk[:, t], jv[:, t], ji[:, t],
                                jf[:, t])
        st, h = S.mlstm_step(st, q[:, t], k[:, t], v[:, t], i[:, t],
                             f[:, t])
        _close(h, jh)
        hs.append(h)
    _close(st, jst)
    seq, _ = S.mlstm_chunkwise(q, k, v, i, f, chunk=4)
    _close(torch.stack(hs, 1), seq.numpy())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
def test_slstm_scan_and_step(per_row):
    """``slstm_scan`` over 12 steps and ``slstm_step`` from its state, with
    shared (H, hd, hd) or per-row (B, H, hd, hd) recurrent weights."""
    hd, s = 8, 12
    pre = _arrays(11, *[(B, s + 1, H, hd)] * 4)
    rshape = (B, H, hd, hd) if per_row else (H, hd, hd)
    rec = _arrays(12, *[rshape] * 4, scale=0.3)
    (jpre, jrec), (tpre, trec) = zip(_both(pre), _both(rec))
    jh, jst = JS.slstm_scan(*(t[:, :s] for t in jpre), *jrec)
    h, st = S.slstm_scan(*(t[:, :s] for t in tpre), *trec)
    _close(h, jh)
    _close(st, jst)
    jst, jh = JS.slstm_step(jst, *(t[:, s] for t in jpre), *jrec)
    st, h = S.slstm_step(st, *(t[:, s] for t in tpre), *trec)
    _close(h, jh)
    _close(st, jst)


def test_slstm_step_takes_fp16_recurrent_weights():
    """A fused variant carries r_* as fp16 extras: they meet the fp32
    state in fp32, as JAX promotes them."""
    hd = 8
    pre = _arrays(13, *[(B, H, hd)] * 4)
    rec = [r.astype(np.float16) for r in _arrays(14, *[(H, hd, hd)] * 4,
                                                 scale=0.3)]
    (jpre, jrec), (tpre, trec) = zip(_both(pre), _both(rec))
    jst = JS.slstm_init_state(B, H, hd)
    st = S.slstm_init_state(B, H, hd, "cpu")
    _, jh = JS.slstm_step(jst, *jpre, *jrec)
    _, h = S.slstm_step(st, *tpre, *trec)
    assert h.dtype == torch.float32
    _close(h, jh)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def _mamba_inputs(seed, s, p=8, n=4, per_row=False):
    x, bm, cm, dt_raw = _arrays(seed, (B, s, H, p), (B, s, n), (B, s, n),
                                (B, s, H))
    lead = (B, H) if per_row else (H,)
    a_log, d_skip = _arrays(seed + 1, lead, lead, scale=0.5)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)      # softplus
    return x, bm, cm, dt, a_log, d_skip


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("s,chunk", [(40, 20), (32, 16)])
def test_mamba_chunkwise_with_state_continuation(per_row, s, chunk):
    arrs = _mamba_inputs(s, s, per_row=per_row)
    (jx, jb, jc, jd, ja, jds), (x, bm, cm, dt, a, ds) = _both(arrs)
    half = s // 2
    jy1, jst = JS.mamba_chunkwise(jx[:, :half], jb[:, :half], jc[:, :half],
                                  jd[:, :half], ja, jds, chunk=chunk)
    jy2, jst = JS.mamba_chunkwise(jx[:, half:], jb[:, half:], jc[:, half:],
                                  jd[:, half:], ja, jds, state=jst,
                                  chunk=chunk)
    y1, st = S.mamba_chunkwise(x[:, :half], bm[:, :half], cm[:, :half],
                               dt[:, :half], a, ds, chunk=chunk)
    y2, st = S.mamba_chunkwise(x[:, half:], bm[:, half:], cm[:, half:],
                               dt[:, half:], a, ds, state=st, chunk=chunk)
    _close(y1, jy1)
    _close(y2, jy2)
    _close(st, jst)


@pytest.mark.parametrize("per_row", [False, True])
def test_mamba_step_matches_jax_and_the_chunkwise_form(per_row):
    s = 6
    arrs = _mamba_inputs(21, s, per_row=per_row)
    (jx, jb, jc, jd, ja, jds), (x, bm, cm, dt, a, ds) = _both(arrs)
    jst = JS.mamba_init_state(B, H, 8, 4)
    st = S.mamba_init_state(B, H, 8, 4, "cpu")
    ys = []
    for t in range(s):
        jst, jy = JS.mamba_step(jst, jx[:, t], jb[:, t], jc[:, t], jd[:, t],
                                ja, jds)
        st, y = S.mamba_step(st, x[:, t], bm[:, t], cm[:, t], dt[:, t], a,
                             ds)
        _close(y, jy)
        ys.append(y)
    _close(st, jst)
    seq, _ = S.mamba_chunkwise(x, bm, cm, dt, a, ds, chunk=3)
    _close(torch.stack(ys, 1), seq.numpy())


def _bf16(a: np.ndarray):
    """(JAX bf16 array, port bf16 tensor) with the same bits."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(bridge.to_numpy(t)).view(jnp.bfloat16), t


def test_mamba_chunkwise_bf16_rounds_its_intra_chunk_operands_as_jax():
    """bf16 inputs (serving): the port within 2e-2 of JAX, where a port
    that contracted the intra-chunk operands in fp32 without rounding
    them to bf16 first lands at least 0.25 away."""
    x, bm, cm, dt, a, ds = _mamba_inputs(31, 32, p=16, n=16)
    x, bm, cm = 4 * x, 2 * bm, 2 * cm
    (jx, x_t), (jb, b_t), (jc, c_t) = _bf16(x), _bf16(bm), _bf16(cm)
    dt_t, a_t, ds_t = (torch.from_numpy(t) for t in (dt, a, ds))
    jy, jst = JS.mamba_chunkwise(jx, jb, jc, jnp.asarray(dt), jnp.asarray(a),
                                 jnp.asarray(ds), chunk=16)
    y, st = S.mamba_chunkwise(x_t, b_t, c_t, dt_t, a_t, ds_t, chunk=16)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0, atol=2e-2)
    _close(st, jst)
    # the same function without the rounding, for contrast
    unrounded, _ = S.mamba_chunkwise(x_t.float(), b_t.float(), c_t.float(),
                                     dt_t, a_t, ds_t, chunk=16)
    assert np.abs(unrounded.to(torch.bfloat16).float().numpy()
                  - want).max() >= 0.25


def _long_chunk_inputs(cell: str, s: int = 256):
    """Inputs whose decay exponent above a 256-step chunk's diagonal
    passes fp32's exp range: forget gates near their init (log σ ≈ -0.7 a
    step) for mLSTM, dt·a ≈ -1 a step for Mamba2."""
    if cell == "mlstm":
        q, k, v = _arrays(51, *[(B, s, H, 8)] * 3)
        ig, fg = _arrays(52, (B, s, H), (B, s, H), scale=0.3)
        return q, k, v, ig, fg
    x, bm, cm, dt, a_log, d_skip = _mamba_inputs(53, s)
    return x, bm, cm, dt, np.abs(a_log) + 0.5, d_skip


@pytest.mark.parametrize("cell", ["mlstm", "mamba"])
def test_chunkwise_backward_over_a_long_chunk_is_finite(cell, monkeypatch):
    """Training at 512 tokens takes 256-step chunks, where the masked
    half of the intra-chunk decay overflows fp32 before the mask: the
    mask is applied in the exponent, so every gradient is finite.  The
    output and every gradient lie within 2e-4 of their largest |value| of
    the same function evaluated in float64 (where nothing overflows; the
    long chunk's own fp32 error reaches 6.7e-5 of it, 16-step chunks'
    7e-6), and the output within as much of JAX's."""
    fn = S.mlstm_chunkwise if cell == "mlstm" else S.mamba_chunkwise
    jfn = JS.mlstm_chunkwise if cell == "mlstm" else JS.mamba_chunkwise
    arrs = _long_chunk_inputs(cell)
    dy = _arrays(54, (B, 256) + arrs[0].shape[2:])[0]

    def grads(dtype):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in arrs]
        y, _ = fn(*ts, chunk=256)
        return y, torch.autograd.grad(y, ts, torch.from_numpy(dy).to(dtype))
    y, got = grads(torch.float32)
    monkeypatch.setattr(S, "F32", torch.float64)
    y64, want = grads(torch.float64)
    _close(y.detach(), y64.detach().numpy(), rel=2e-4)
    _close(y.detach(), np.asarray(jfn(*(jnp.asarray(a) for a in arrs),
                                      chunk=256)[0]), rel=2e-4)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w.numpy(), rel=2e-4)
