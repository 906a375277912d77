"""Port parity: forward flash attention.  The port's
``ops.flash_attention_fwd`` (its plain version, on the CPU) against the JAX
package's Pallas kernel run in interpret mode (``K.flash_attention_fwd``),
over every case of tests/test_flash_kernel.py plus odd S, hd 256 and a query
block that starts before the first key (``q_offset < kv_offset``: rows that
see no key average v over all T in both).  ``attention_ref`` is held against
the JAX one.  Inputs are made with numpy from a seed.

Tolerances: 2e-4 abs+rel in fp32 (the two sum in another order), as in
tests/test_flash_kernel.py; in bf16 5e-4 + 1e-2·|JAX|, tighter than that
file's 3e-2: both round one fp32 value to bf16, so they differ by one bf16
step at most.  The CUDA kernel itself is
checked against the plain version in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as JK  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402


def _qkv(seed, b, s, t, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, hq, hd), (b, t, hkv, hd),
                               (b, t, hkv, hd)))


def _both(arrs, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


CASES = (
    # test_flash_kernel.py: reference cases, non-causal
    [("ref", hq, hkv, s, t, 16, False, 0, 0, "float32")
     for hq, hkv in ((4, 4), (4, 2), (8, 1)) for s, t in ((16, 16), (8, 32))]
    # causal
    + [("causal", hq, hkv, 32, 32, 8, True, 0, 0, "float32")
       for hq, hkv in ((4, 4), (4, 2))]
    # bf16
    + [("bf16", 4, 4, 16, 16, 16, True, 0, 0, "bfloat16")]
    # absolute offsets
    + [("offsets", 2, 2, 8, 24, 8, True, 16, 0, "float32")]
    # new: odd S and T, hd 256, rows that see no key
    + [("odd", 4, 2, 13, 13, 16, True, 0, 0, "float32"),
       ("odd", 4, 2, 13, 21, 16, False, 0, 0, "float32"),
       ("hd256", 4, 2, 16, 16, 256, True, 0, 0, "float32"),
       ("no-key", 4, 2, 8, 16, 16, True, 0, 4, "float32"),
       ("no-key", 4, 1, 8, 16, 16, True, 2, 12, "bfloat16")])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_jax_kernel(case):
    _, hq, hkv, s, t, hd, causal, q_off, kv_off, dtype = case
    (jq, jk, jv), (q, k, v) = _both(_qkv(len(str(case)), 2 if s < 32 else 1,
                                         s, t, hq, hkv, hd), dtype)
    want = JK.flash_attention_fwd(jq, jk, jv, causal=causal,
                                  q_offset=q_off, kv_offset=kv_off)
    got = K.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_off,
                                kv_offset=kv_off)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    _close(got, want, *((5e-4, 1e-2) if dtype == "bfloat16"
                        else (2e-4, 2e-4)))


def test_rows_without_a_visible_key_average_v():
    """q_offset < kv_offset: the first rows see no key, and -1e30 (not -inf)
    masking gives them the mean of v, as the TPU kernel computes."""
    (_, _, _), (q, k, v) = _both(_qkv(3, 1, 8, 16, 2, 2, 16), "float32")
    got = K.flash_attention_fwd(q, k, v, causal=True, q_offset=0,
                                kv_offset=4)
    mean_v = v.mean(dim=1)                       # (B, Hkv, hd)
    torch.testing.assert_close(got[:, :4], mean_v[:, None].expand(
        1, 4, 2, 16), rtol=1e-5, atol=1e-6)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("causal,window,q_off,kv_off",
                         [(True, 0, 0, 0), (False, 0, 0, 0),
                          (True, 5, 0, 0), (True, 0, 16, 0),
                          (True, 0, 0, 4)])
def test_attention_ref_matches_jax(causal, window, q_off, kv_off):
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, 2, 8, 24, 4, 2, 8), "float32")
    want = JA.attention_ref(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_off, kv_offset=kv_off)
    got = A.attention_ref(q, k, v, causal=causal, window=window,
                          q_offset=q_off, kv_offset=kv_off)
    _close(got, want, 1e-5, 1e-5)


def test_plain_versions_agree_with_chunked_flash_attention():
    """The kernel's plain version against the models' chunked jnp-style
    ``flash_attention`` (what prefill runs) in fp32."""
    (_, _, _), (q, k, v) = _both(_qkv(9, 1, 24, 24, 4, 2, 16), "float32")
    got = K.flash_attention_fwd(q, k, v, causal=True)
    want = A.flash_attention(q, k, v, causal=True, chunk=8)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _emulate_bf16_kernel(q, k, v, *, group, causal, q_offset, kv_offset,
                         bk):
    """The arithmetic of csrc/flash_attn.cu's bf16 (wgmma) kernel on the
    CPU: bf16·bf16 scores summed in fp32, then × hd^-½·log2(e); -1e30 for a
    masked score; an online softmax over key tiles of ``bk`` in base 2 with
    fp32 statistics; P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
    each multiplied by bf16 V in fp32; o = acc / max(l, 1e-30), rounded once
    to bf16.  q (BH, S, hd), k and v (BH/group, T, hd), bf16."""
    bh, s, hd = q.shape
    t = k.shape[1]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    scores = (q.float() @ kf.transpose(1, 2)) * (hd ** -0.5 * np.log2(np.e))
    if causal:
        q_pos = q_offset + torch.arange(s)[:, None]
        k_pos = kv_offset + torch.arange(t)[None, :]
        scores = torch.where(q_pos >= k_pos, scores,
                             torch.tensor(-1e30, dtype=torch.float32))
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, hd))
    for k0 in range(0, t, bk):
        st = scores[:, :, k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        acc = (acc * alpha + p_hi @ vf[:, k0:k0 + bk]
               + p_lo @ vf[:, k0:k0 + bk])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("hd,bk", [(64, 128), (128, 128), (256, 64)])
@pytest.mark.parametrize("s,t,q_off,kv_off", [
    (8, 8, 0, 0),        # row i sees i + 1 keys: 1..8
    (12, 20, 0, 0),      # 1..12 visible keys, the rest masked
    (8, 16, 2, 12),      # rows 0..9 of the block see no key: mean of v
    (5, 200, 190, 0),    # long rows spanning key tiles, ragged T
])
def test_bf16_kernel_arithmetic_stays_within_tolerance(hd, bk, s, t, q_off,
                                                       kv_off):
    """The bf16 kernel's arithmetic (emulated, ``_emulate_bf16_kernel``)
    against the plain version and the JAX kernel: within FLASH_TOL[bf16]
    (5e-4 + 1e-2·|plain|) on rows with 1-8 visible keys, rows that see no
    key, and rows over several key tiles."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(hd + s + t, 1, s, t, 4, 2, hd),
                                    "bfloat16")
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off)
    want = K.flash_attention_fwd(q, k, v, **kw).float()   # (B, S, H, hd)
    flat = [x.transpose(1, 2).reshape(-1, x.shape[1], hd) for x in (q, k, v)]
    got = _emulate_bf16_kernel(*flat, group=2, bk=bk, **kw)
    got = got.reshape(1, 4, s, hd).transpose(1, 2)
    _close(got, want.numpy(), 5e-4, 1e-2)
    jwant = JK.flash_attention_fwd(jq, jk, jv, **kw)
    _close(got, jwant, 5e-4, 1e-2)
