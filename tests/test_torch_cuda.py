"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips on a CPU host; the
decision is taken inside the ``cuda`` fixture, never at import time.

Run on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``unpack_apply`` does the plain version's arithmetic exactly
(one fp32 add per element), so it must be bit-identical.
``bitlinear_axes`` builds the same fp32 Ŵ and sums the products in another
order; the bound is 1e-5 relative to Σ|x||Ŵ| per output (fp32 summation of
K ≤ 4096 terms).  ``bitlinear_axes_banked`` is held to the same bound, with
Ŵ of each row's own bank slot; with every row on one slot of a bank it must
equal, bit for bit, the same kernel over a bank of that slot alone beside
the base (same tiles, same split-K order), and agree with
``bitlinear_axes`` within the GEMM bound (the two kernels sum in different
orders: the single-variant one streams W_b at decode-sized M).

Over an int8 base (``core/quantize``) the same bounds hold with Ŵ built
from the dequantized base: the kernels form q·s in fp32 as the plain
versions do, so ``unpack_apply`` stays bit-identical.  ``bitlinear_p`` (the
static-mode GEMM) is held to the GEMM bound in its three modes, and
``bitlinear_axes_stacked_p`` (one launch over an MoE layer's expert stack)
to the same bound per expert, Ŵ of the row's own expert; over a stack of
one expert it is held to that bound against ``bitlinear_axes_p`` (the two
kernels sum in different orders).  An expert whose rows of x are all ±0
gets exact zeros without a read of its weights, so the stacked kernel's
other outputs must equal, bit for bit, a launch in which those rows hold
random values (same plan: it sees no routing).

``flash_attention_fwd_p`` sums its products and its softmax in another
order than its plain version (a dense fp32 softmax): within 2e-4 abs+rel in
fp32; in bf16 within 5e-4 + 1e-2·|plain|, since both round one fp32 value
to bf16 and so differ by one bf16 step of the output at most (the bf16
kernel's tensor-core products keep P as two bf16 terms, about 16 bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import delta as D  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.kernels import bitlinear as BL  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import unpack_apply as UA  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none on this host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _delta_case(rng, lead, d_out, d_in, device):
    wb = (rng.standard_normal(lead + (d_out, d_in)) * 0.1).astype(np.float32)
    delta = (rng.standard_normal(lead + (d_out, d_in)) * 0.01).astype(
        np.float32)
    packed = D.pack_signs(D.sign_mask(torch.from_numpy(delta)))
    return (torch.from_numpy(wb).to(device), packed.to(device),
            torch.from_numpy(delta).to(device))


@pytest.mark.parametrize("shape", [(1, 8, 16), (3, 100, 40), (2, 64, 512)])
@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
@pytest.mark.parametrize("wdt,odt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_unpack_apply_matches_plain(cuda, shape, mode, wdt, odt):
    rng = np.random.default_rng(0)
    lead, d_out, d_in = shape[:1], shape[1], shape[2]
    wb, packed, delta = _delta_case(rng, lead, d_out, d_in, cuda)
    wb = wb.to(wdt)
    v = D.init_scale(delta, mode)
    before = UA.launches
    got = K.unpack_apply(packed, v, wb, mode=mode, out_dtype=odt)
    torch.cuda.synchronize()
    assert UA.launches == before + 1
    want = R.unpack_apply_ref(packed, v, wb, mode, dtype=odt)
    assert got.dtype == odt and got.shape == wb.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("mnk", [(4, 64, 128), (5, 100, 40), (4, 64, 4096),
                                 (64, 96, 256), (33, 130, 1032)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdt", [torch.float16, torch.float32])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_bitlinear_axes_matches_plain(cuda, mnk, xdt, vdt, wdt):
    m, n, k = mnk
    rng = np.random.default_rng(1)
    wb, packed, delta = _delta_case(rng, (), n, k, cuda)
    wb = wb.to(wdt)
    vr = D.init_scale(delta, "row").to(vdt)
    vc = torch.zeros(k, dtype=vdt, device=cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    before = BL.launches
    got = BL.bitlinear_axes_p(x, packed, vr, vc, wb)
    torch.cuda.synchronize()
    assert BL.launches == before + 1
    want = R.bitlinear_axes_ref(x.float(), packed, vr, vc, wb)
    signs = D.unpack_signs(packed, k)
    w_abs = ((vr.float()[:, None] + vc.float()[None, :]) * signs
             + wb.float()).abs()
    scale = x.float().abs() @ w_abs.T
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("m", [1, 3, 4, 16, 17, 64])
@pytest.mark.parametrize("nk", [(130, 1032), (1024, 4096)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("vdt", [torch.float16, torch.float32])
def test_delta_gemm_across_m(cuda, m, nk, xdt, wdt, vdt):
    """``bitlinear_axes_p`` through both kernels of csrc/delta_gemm.cuh
    (streaming for M <= 16 in its three row tiers, tiled above) with both
    axis vectors non-zero, over every x, W_b and vector dtype: the GEMM
    bound against the plain version; and ``bitlinear_p`` in col mode on the
    same operands."""
    n, k = nk
    rng = np.random.default_rng(m + n)
    wb, packed, delta = _delta_case(rng, (), n, k, cuda)
    ws = None
    if wdt == torch.int8:
        qw = Q.quantize_weight(wb)
        wb, ws = qw.q, qw.scale
    else:
        wb = wb.to(wdt)
    vr = D.init_scale(delta, "row").to(vdt)
    vc = (D.init_scale(delta, "col") * 0.5).to(vdt)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    before = BL.launches
    got = BL.bitlinear_axes_p(x, packed, vr, vc, wb, ws)
    torch.cuda.synchronize()
    assert BL.launches == before + 1 and got.shape == (m, n)
    want = R.bitlinear_axes_ref(x.float(), packed, vr, vc, wb, w_scale=ws)
    signs = D.unpack_signs(packed, k)
    w_abs = ((vr.float()[:, None] + vc.float()[None, :]) * signs
             + R._deq(wb, ws)).abs()
    scale = x.float().abs() @ w_abs.T
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    got = BL.bitlinear_p(x, packed, vc.float().reshape(1, k), wb, ws)
    want = R.bitlinear_ref(x.float(), packed, vc.float(), wb, "col",
                           w_scale=ws)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_bitlinear_axes_wrapper_batch_dims_and_col_axis(cuda):
    rng = np.random.default_rng(2)
    wb, packed, delta = _delta_case(rng, (), 48, 64, cuda)
    vr = torch.zeros(48, dtype=torch.float16, device=cuda)
    vc = D.init_scale(delta, "col").to(torch.float16)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    got = K.bitlinear_axes(x, packed, vr, vc, wb)
    assert got.shape == (2, 3, 48) and got.dtype == torch.bfloat16
    with K.plain_versions():
        want = K.bitlinear_axes(x, packed, vr, vc, wb)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 2 ** -7 * want.float().abs().max().item()


def _bank_case(rng, nbank, n, k, device, vdt=torch.float16):
    """A bank of ``nbank`` slots over one (n, k) base: slot 0 all zero,
    odd slots row-scaled, even slots col-scaled (the overlay's canonical
    form), each from its own random delta."""
    wb = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    packed = torch.zeros((nbank, n, k // 8), dtype=torch.uint8)
    v_row = torch.zeros((nbank, n))
    v_col = torch.zeros((nbank, k))
    for s in range(1, nbank):
        delta = torch.from_numpy((rng.standard_normal((n, k)) * 0.01
                                  ).astype(np.float32))
        packed[s] = D.pack_signs(D.sign_mask(delta))
        if s % 2:
            v_row[s] = D.init_scale(delta, "row")
        else:
            v_col[s] = D.init_scale(delta, "col")
    return (torch.from_numpy(wb).to(device), packed.to(device),
            v_row.to(vdt).to(device), v_col.to(vdt).to(device))


def _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wb):
    """|kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per output, Ŵ of the
    row's own slot."""
    want = R.bitlinear_axes_banked_ref(x.float(), vidx, packed, v_row, v_col,
                                       wb)
    scale = torch.zeros_like(want)
    for s in range(packed.shape[0]):
        signs = D.unpack_signs(packed[s], x.shape[1])
        w_abs = ((v_row[s].float()[:, None] + v_col[s].float()[None, :])
                 * signs + wb.float()).abs()
        scale = torch.where(vidx[:, None] == s, x.float().abs() @ w_abs.T,
                            scale)
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("mnk", [(4, 64, 128), (5, 100, 40), (4, 1024, 4096),
                                 (64, 96, 256), (33, 130, 1032)])
@pytest.mark.parametrize("nbank", [2, 5])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_bitlinear_axes_banked_matches_plain(cuda, mnk, nbank, xdt, wdt):
    m, n, k = mnk
    rng = np.random.default_rng(4)
    wb, packed, v_row, v_col = _bank_case(rng, nbank, n, k, cuda)
    wb = wb.to(wdt)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    vidx = torch.from_numpy(rng.integers(0, nbank, m).astype(np.int32)
                            ).to(cuda)
    before = BL.banked_launches
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
    torch.cuda.synchronize()
    assert BL.banked_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wb)


@pytest.mark.parametrize("m", [16, 64])
def test_bitlinear_axes_banked_more_slots_than_one_pass(cuda, m):
    """Eight distinct slots among the rows: at M=16 the streaming kernel's
    groups of four sorted rows, at M=64 more slots in one 64-row block than
    the tiled kernel's three Ŵ tiles, so three passes over each x tile."""
    rng = np.random.default_rng(5)
    wb, packed, v_row, v_col = _bank_case(rng, 8, 96, 512, cuda,
                                          vdt=torch.float32)
    x = torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32)
                         ).to(cuda)
    vidx = torch.arange(m, dtype=torch.int32, device=cuda) % 8
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wb)


def test_bitlinear_axes_banked_base_rows_equal_plain_product(cuda):
    rng = np.random.default_rng(6)
    wb, packed, v_row, v_col = _bank_case(rng, 4, 1024, 4096, cuda)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda)
    vidx = torch.zeros(4, dtype=torch.int32, device=cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
    want = x @ wb.T
    scale = x.abs() @ wb.abs().T
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def _uniform_bound(x, packed, v_row, v_col, wb, ws=None):
    """The GEMM bound 1e-5·Σ|x||Ŵ| + 1e-6 of one slot's product."""
    signs = D.unpack_signs(packed, x.shape[1])
    w_abs = ((v_row.float()[:, None] + v_col.float()[None, :]) * signs
             + R._deq(wb, ws)).abs()
    return 1e-5 * (x.float().abs() @ w_abs.T) + 1e-6


def _single_variant_bank(packed, v_row, v_col, s):
    """(packed, v_row, v_col, slot) of a bank holding only slot ``s`` of
    the given bank beside its base slot 0 (or the base alone for s = 0)."""
    keep = [0] if s == 0 else [0, s]
    return (packed[keep].contiguous(), v_row[keep].contiguous(),
            v_col[keep].contiguous(), len(keep) - 1)


def test_bitlinear_axes_banked_uniform_equals_single_variant(cuda):
    """Every row on slot s of a 3-slot bank: the banked kernel gives, bit for
    bit, what it gives over a bank of slot s alone (same tiles, same split-K
    order), so no row reads another slot's signs or vectors."""
    rng = np.random.default_rng(7)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 1024, 4096, cuda)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    for s in range(3):
        vidx = torch.full((4,), s, dtype=torch.int32, device=cuda)
        got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
        p1, vr1, vc1, slot = _single_variant_bank(packed, v_row, v_col, s)
        want = BL.bitlinear_axes_banked_p(
            x, torch.full((4,), slot, dtype=torch.int32, device=cuda),
            p1, vr1, vc1, wb)
        assert torch.equal(got, want), s


def test_bitlinear_axes_banked_uniform_matches_single_variant_kernel(cuda):
    """Every row on one slot: the banked kernel and bitlinear_axes_p compute
    the same product (the two sum in different orders since the single-
    variant kernel streams W_b at decode-sized M: within the GEMM bound of
    each other)."""
    rng = np.random.default_rng(7)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 1024, 4096, cuda)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    for s in range(3):
        vidx = torch.full((4,), s, dtype=torch.int32, device=cuda)
        got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
        want = BL.bitlinear_axes_p(x, packed[s].contiguous(), v_row[s],
                                   v_col[s], wb)
        bound = _uniform_bound(x, packed[s], v_row[s], v_col[s], wb)
        assert bool(((got - want).abs() <= bound).all()), s


def test_bitlinear_axes_banked_wrapper_batch_dims(cuda):
    rng = np.random.default_rng(8)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 48, 64, cuda)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    vidx = torch.tensor([2, 0, 1], device=cuda)
    got = K.bitlinear_axes_banked(x, vidx, packed, v_row, v_col, wb)
    assert got.shape == (3, 5, 48) and got.dtype == torch.bfloat16
    with K.plain_versions():
        want = K.bitlinear_axes_banked(x, vidx, packed, v_row, v_col, wb)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= 2 ** -7 * want.float().abs().max().item()


OUT_OF_RANGE = r"""
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import bitlinear as BL
dev = torch.device("cuda")
x = torch.ones((4, 64), device=dev)
packed = torch.zeros((2, 32, 8), dtype=torch.uint8, device=dev)
vr = torch.zeros((2, 32), dtype=torch.float16, device=dev)
vc = torch.zeros((2, 64), dtype=torch.float16, device=dev)
wb = torch.ones((32, 64), device=dev)
vidx = torch.tensor([0, 1, %d, 0], dtype=torch.int32, device=dev)
try:
    y = BL.bitlinear_axes_banked_p(x, vidx, packed, vr, vc, wb)
    torch.cuda.synchronize()
    print("RESULT", y.sum().item())
except RuntimeError as e:    # torch's CUDA errors subclass RuntimeError
    print("RAISED", type(e).__name__, str(e).splitlines()[0])
"""


@pytest.mark.parametrize("bad", [2, -1])
def test_bitlinear_axes_banked_refuses_out_of_range_slot(cuda, bad):
    """A slot index outside [0, V) fails the launch (the kernel traps
    before any bank read); a trap ends the process's CUDA context, so the
    call runs in a child process."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", OUT_OF_RANGE % bad],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert "RESULT" not in out.stdout, out.stdout
    assert "RAISED" in out.stdout and "CUDA error" in out.stdout, (
        out.stdout, out.stderr)


def test_kernel_wrappers_reject_what_they_cannot_run(cuda):
    rng = np.random.default_rng(3)
    wb, packed, delta = _delta_case(rng, (), 32, 64, cuda)
    v = D.init_scale(delta, "row")
    with pytest.raises(ValueError):
        K.unpack_apply(packed.cpu(), v, wb, mode="row")     # mixed devices
    with pytest.raises(ValueError):
        UA.unpack_apply_p(packed, v.reshape(32, 1), wb.T.contiguous().T,
                          torch.float32)                     # not contiguous
    x = torch.ones((4, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):                          # fp16 x
        BL.bitlinear_axes_p(x, packed, v, torch.zeros(64, device=cuda), wb)


def test_banked_wrapper_rejects_what_it_cannot_run(cuda):
    rng = np.random.default_rng(9)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 32, 64, cuda)
    x = torch.ones((4, 64), device=cuda)
    vidx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                          # vidx on the CPU
        BL.bitlinear_axes_banked_p(x, vidx.cpu(), packed, v_row, v_col, wb)
    with pytest.raises(ValueError):                          # int64 vidx
        BL.bitlinear_axes_banked_p(x, vidx.long(), packed, v_row, v_col, wb)
    with pytest.raises(ValueError):                          # not contiguous
        BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col,
                                   wb.T.contiguous().T)
    with pytest.raises(ValueError):                          # bank mismatch
        BL.bitlinear_axes_banked_p(x, vidx, packed, v_row[:2], v_col, wb)
    with pytest.raises(ValueError):                          # fp16 x
        BL.bitlinear_axes_banked_p(x.half(), vidx, packed, v_row, v_col, wb)


# ---------------------------------------------------------------------------
# int8 base (the _q8 bodies) and the static-mode bitlinear_p
# ---------------------------------------------------------------------------

def _gemm_within_tolerance(got, x, w_hat):
    """|kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per output."""
    want = x.float() @ w_hat.T
    scale = x.float().abs() @ w_hat.abs().T
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("scale", [0.1, 1.0, 37.0])
def test_quantize_weight_on_the_card_equals_the_cpu(cuda, scale):
    """The int8 base quantized on the card has the CPU's (and so the JAX
    package's) bytes and scale bits."""
    rng = np.random.default_rng(17)
    w = torch.from_numpy((rng.standard_normal((4, 1024, 4096)) * scale
                          ).astype(np.float32))
    on_cpu, on_card = Q.quantize_weight(w), Q.quantize_weight(w.to(cuda))
    assert torch.equal(on_card.q.cpu(), on_cpu.q)
    assert torch.equal(on_card.scale.cpu().view(torch.int16),
                       on_cpu.scale.view(torch.int16))


@pytest.mark.parametrize("shape", [(1, 8, 16), (3, 100, 40), (2, 64, 512),
                                   (4, 1024, 4096)])
@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
@pytest.mark.parametrize("odt", [torch.float32, torch.bfloat16,
                                 torch.float16])
def test_unpack_apply_q8_matches_plain(cuda, shape, mode, odt):
    rng = np.random.default_rng(10)
    wb, packed, delta = _delta_case(rng, shape[:1], shape[1], shape[2], cuda)
    qw = Q.quantize_weight(wb)
    v = D.init_scale(delta, mode)
    before = UA.launches
    got = K.unpack_apply(packed, v, qw, mode=mode, out_dtype=odt)
    torch.cuda.synchronize()
    assert UA.launches == before + 1
    want = R.unpack_apply_ref(packed, v, qw.q, mode, dtype=odt,
                              w_scale=qw.scale)
    assert got.dtype == odt and torch.equal(got, want)
    # the wrapper's default output dtype over an int8 base is the scale's
    assert K.unpack_apply(packed, v, qw, mode=mode).dtype == torch.float16


@pytest.mark.parametrize("mnk", [(4, 64, 128), (5, 100, 40), (4, 1024, 4096),
                                 (64, 96, 256), (33, 130, 1032)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdt", [torch.float16, torch.float32])
def test_bitlinear_axes_q8_matches_plain(cuda, mnk, xdt, vdt):
    m, n, k = mnk
    rng = np.random.default_rng(11)
    wb, packed, delta = _delta_case(rng, (), n, k, cuda)
    qw = Q.quantize_weight(wb)
    vr = D.init_scale(delta, "row").to(vdt)
    vc = D.init_scale(delta, "col").to(vdt)    # both axes: the kernel sums
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    before = BL.launches
    got = BL.bitlinear_axes_p(x, packed, vr, vc, qw.q, w_scale=qw.scale)
    torch.cuda.synchronize()
    assert BL.launches == before + 1 and got.dtype == torch.float32
    signs = D.unpack_signs(packed, k)
    w_hat = ((vr.float()[:, None] + vc.float()[None, :]) * signs
             + Q.dequantize(qw))
    assert _gemm_within_tolerance(got, x, w_hat)
    want = R.bitlinear_axes_ref(x.float(), packed, vr, vc, qw.q,
                                w_scale=qw.scale)
    scale = x.float().abs() @ w_hat.abs().T
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("mnk", [(4, 64, 128), (5, 100, 40), (4, 1024, 4096),
                                 (64, 96, 256), (33, 130, 1032)])
@pytest.mark.parametrize("nbank", [2, 5])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_bitlinear_axes_banked_q8_matches_plain(cuda, mnk, nbank, xdt):
    m, n, k = mnk
    rng = np.random.default_rng(12)
    wb, packed, v_row, v_col = _bank_case(rng, nbank, n, k, cuda)
    qw = Q.quantize_weight(wb)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    vidx = torch.from_numpy(rng.integers(0, nbank, m).astype(np.int32)
                            ).to(cuda)
    before = BL.banked_launches
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, qw.q,
                                     w_scale=qw.scale)
    torch.cuda.synchronize()
    assert BL.banked_launches == before + 1
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col,
                                    Q.dequantize(qw))


def test_bitlinear_axes_banked_q8_uniform_equals_single_variant(cuda):
    rng = np.random.default_rng(13)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 1024, 4096, cuda)
    qw = Q.quantize_weight(wb)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    for s in range(3):
        vidx = torch.full((4,), s, dtype=torch.int32, device=cuda)
        got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col,
                                         qw.q, w_scale=qw.scale)
        p1, vr1, vc1, slot = _single_variant_bank(packed, v_row, v_col, s)
        want = BL.bitlinear_axes_banked_p(
            x, torch.full((4,), slot, dtype=torch.int32, device=cuda),
            p1, vr1, vc1, qw.q, w_scale=qw.scale)
        assert torch.equal(got, want), s


def test_bitlinear_axes_banked_q8_uniform_matches_single_variant_kernel(
        cuda):
    rng = np.random.default_rng(13)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 1024, 4096, cuda)
    qw = Q.quantize_weight(wb)
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    for s in range(3):
        vidx = torch.full((4,), s, dtype=torch.int32, device=cuda)
        got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col,
                                         qw.q, w_scale=qw.scale)
        want = BL.bitlinear_axes_p(x, packed[s].contiguous(), v_row[s],
                                   v_col[s], qw.q, w_scale=qw.scale)
        bound = _uniform_bound(x, packed[s], v_row[s], v_col[s], qw.q,
                               qw.scale)
        assert bool(((got - want).abs() <= bound).all()), s


def _banked_base(wb, wdt):
    """(payload, scale or None, dense fp32 base) of a test base in ``wdt``."""
    if wdt == torch.int8:
        qw = Q.quantize_weight(wb)
        return qw.q, qw.scale, Q.dequantize(qw)
    w = wb.to(wdt)
    return w, None, w.float()


@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("slots", [1, 2, 4, 5, 8, "one"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_bitlinear_axes_banked_edges(cuda, m, slots, wdt, xdt):
    """The banked kernels at their edges: one to four groups of four rows
    of the streaming kernel (M 1..16) and the tiled one (17, 64); 1 to
    min(M, 8) distinct non-zero slots with base rows between them (a group
    of four distinct slots, at M 8..16 with 8 slots, takes two streaming
    passes), or every row on one slot; N a multiple of neither 32 nor 128
    and K of no stream step.  The GEMM bound against the plain version, Ŵ
    of each row's own slot."""
    n, k = 130, 1288
    rng = np.random.default_rng(100 + m)
    wb, packed, v_row, v_col = _bank_case(rng, 9, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    if slots == "one":
        vlist = [3] * m
    else:
        used = min(slots, m)
        vlist = [r % (used + 1) for r in range(m)]   # slot 0 between
    vidx = torch.tensor(vlist, dtype=torch.int32, device=cuda)
    before = BL.banked_launches
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert BL.banked_launches == before + 1 and got.shape == (m, n)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("lanes", [[0, 1, 2, 1], [1, 2, 3, 4, 5]])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
def test_bitlinear_axes_banked_prefill_lanes_span_microtiles(cuda, lanes,
                                                              wdt):
    """A continuous prefill whose lanes are 13 tokens long: a thread's eight
    rows span two lanes, so two slots (and with five distinct slots in one
    64-row block, more than one tiled pass of four tiles)."""
    rng = np.random.default_rng(21)
    wb, packed, v_row, v_col = _bank_case(rng, 6, 200, 1032, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    vlist = [s for s in lanes for _ in range(13)]
    x = torch.from_numpy(rng.standard_normal((len(vlist), 1032)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    vidx = torch.tensor(vlist, dtype=torch.int32, device=cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("m", [4, 64])
def test_bitlinear_axes_banked_does_not_synchronise(cuda, m):
    """The wrapper never reads vidx on the host: one call raises nothing
    under PyTorch's synchronisation debug mode."""
    rng = np.random.default_rng(22)
    wb, packed, v_row, v_col = _bank_case(rng, 3, 256, 1024, cuda)
    x = torch.from_numpy(rng.standard_normal((m, 1024)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    vidx = torch.tensor([0, 1, 2, 1] * (m // 4), dtype=torch.int32,
                        device=cuda)
    BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wb)


@pytest.mark.parametrize("mnk", [(4, 64, 128), (5, 100, 40), (4, 1024, 4096),
                                 (64, 96, 256), (33, 130, 1032)])
@pytest.mark.parametrize("mode", ["row", "col", "scalar"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_bitlinear_matches_plain(cuda, mnk, mode, wdt, xdt):
    m, n, k = mnk
    rng = np.random.default_rng(14)
    wb, packed, delta = _delta_case(rng, (), n, k, cuda)
    base = Q.quantize_weight(wb) if wdt == torch.int8 else wb.to(wdt)
    v = D.init_scale(delta, mode).to(torch.float16)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    before = BL.static_launches
    got = K.bitlinear(x, packed, v, base, mode=mode)
    torch.cuda.synchronize()
    assert BL.static_launches == before + 1
    assert got.dtype == xdt and got.shape == (m, n)
    wbf = Q.dequantize(base) if wdt == torch.int8 else base.float()
    w_hat = D.reconstruct(packed, v, wbf, mode, dtype=torch.float32)
    if xdt == torch.float32:
        assert _gemm_within_tolerance(got, x, w_hat)
    else:   # one bf16 rounding of the output
        with K.plain_versions():
            want = K.bitlinear(x, packed, v, base, mode=mode)
        diff = (got.float() - want.float()).abs().max().item()
        assert diff <= 2 ** -7 * want.float().abs().max().item()
    raw = BL.bitlinear_p(x, packed, K._v2d(v, mode, (), n, k),
                         *K._unwrap_quant(base))
    assert _gemm_within_tolerance(raw, x, w_hat)


def test_bitlinear_row_mode_equals_axes_kernel(cuda):
    """Row mode through the strided scale builds the same Ŵ tiles as the
    dual-axis kernel with a zero v_col: equal bit for bit."""
    rng = np.random.default_rng(15)
    wb, packed, delta = _delta_case(rng, (), 1024, 4096, cuda)
    vr = D.init_scale(delta, "row")
    x = torch.from_numpy(rng.standard_normal((4, 4096)).astype(np.float32)
                         ).to(cuda)
    got = BL.bitlinear_p(x, packed, vr.reshape(-1, 1), wb)
    want = BL.bitlinear_axes_p(x, packed, vr,
                               torch.zeros(4096, device=cuda), wb)
    assert torch.equal(got, want)


def test_q8_wrappers_reject_what_they_cannot_run(cuda):
    rng = np.random.default_rng(16)
    wb, packed, delta = _delta_case(rng, (), 32, 64, cuda)
    qw = Q.quantize_weight(wb)
    v = D.init_scale(delta, "row")
    x = torch.ones((4, 64), device=cuda)
    vc = torch.zeros(64, device=cuda)
    # an int8 payload 4 bytes off its 8-byte alignment raises, never copies
    buf = torch.empty(32 * 64 + 4, dtype=torch.int8, device=cuda)
    off = buf[4:].view(32, 64)
    off.copy_(qw.q)
    assert off.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="aligned"):
        BL.bitlinear_axes_p(x, packed, v, vc, off, w_scale=qw.scale)
    with pytest.raises(ValueError, match="aligned"):
        UA.unpack_apply_p(packed, v.reshape(32, 1), off, torch.float32,
                          w_scale=qw.scale)
    with pytest.raises(ValueError, match="aligned"):
        BL.bitlinear_p(x, packed, v.reshape(32, 1), off, w_scale=qw.scale)
    # an int8 payload without its scale, a scale beside an fp base
    with pytest.raises(ValueError):
        BL.bitlinear_axes_p(x, packed, v, vc, qw.q)
    with pytest.raises(ValueError):
        BL.bitlinear_axes_p(x, packed, v, vc, wb, w_scale=qw.scale)
    with pytest.raises(ValueError):                           # fp32 scale
        BL.bitlinear_axes_banked_p(
            x, torch.zeros(4, dtype=torch.int32, device=cuda),
            packed[None], v[None].half(), vc[None].half(), qw.q,
            w_scale=qw.scale.float())
    with pytest.raises(ValueError):                           # (N, K) v2d
        BL.bitlinear_p(x, packed, torch.ones((32, 64), device=cuda), wb)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (5e-4, 1e-2)}


def _flash_case(seed, bh, s, t, hd, group, dtype, device):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    q = torch.randn((bh, s, hd), generator=gen)
    k = torch.randn((bh // group, t, hd), generator=gen)
    v = torch.randn((bh // group, t, hd), generator=gen)
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s,t", [(16, 16), (77, 77), (8, 200), (130, 64)])
@pytest.mark.parametrize("causal,q_off,kv_off", [
    (False, 0, 0), (True, 0, 0), (True, 40, 0), (True, 0, 5), (True, 3, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, hd, s, t, causal, q_off, kv_off,
                                       dtype):
    q, k, v = _flash_case(hd + s + t, 8, s, t, hd, 4, dtype, cuda)
    before = FA.launches
    got = FA.flash_attention_fwd_p(q, k, v, group=4, causal=causal,
                                   q_offset=q_off, kv_offset=kv_off)
    assert FA.launches == before + 1
    want = FA.plain(q, k, v, group=4, causal=causal, q_offset=q_off,
                    kv_offset=kv_off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("s", [16, 512, 4096])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_qwen3_8b_heads(cuda, s, causal, dtype):
    """The serving shapes of chip_smoke.py: 32 query heads over 8 KV heads,
    hd 128, B=1, S=T."""
    q, k, v = _flash_case(s, 32, s, s, 128, 4, dtype, cuda)
    got = FA.flash_attention_fwd_p(q, k, v, group=4, causal=causal)
    want = FA.plain(q, k, v, group=4, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s,t", [(1, 1), (1, 300), (129, 200), (256, 257)])
@pytest.mark.parametrize("causal,q_off,kv_off", [
    (False, 0, 0), (True, 0, 0), (True, 0, 5), (True, 300, 0),
    (True, 2, 140)])
def test_flash_attention_bf16_edges(cuda, hd, s, t, causal, q_off, kv_off):
    """The bf16 (wgmma) kernel at one query row, key counts that are not a
    multiple of its key tile (128; 64 at hd 256), query blocks of 128 rows
    cut by S, and absolute offsets, including blocks whose first rows see
    no key."""
    q, k, v = _flash_case(hd + s + t + q_off, 8, s, t, hd, 4, torch.bfloat16,
                          cuda)
    before = FA.launches
    got = FA.flash_attention_fwd_p(q, k, v, group=4, causal=causal,
                                   q_offset=q_off, kv_offset=kv_off)
    assert FA.launches == before + 1
    want = FA.plain(q, k, v, group=4, causal=causal, q_offset=q_off,
                    kv_offset=kv_off)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_attention_rows_without_a_key_average_v(cuda):
    """q_offset < kv_offset: the tile's first rows see no key and come out
    as the mean of v over all T (the TPU kernel's -1e30 masking)."""
    q, k, v = _flash_case(1, 4, 100, 300, 128, 2, torch.float32, cuda)
    got = FA.flash_attention_fwd_p(q, k, v, group=2, causal=True,
                                   q_offset=0, kv_offset=30)
    mean_v = v.mean(dim=1).repeat_interleave(2, dim=0)      # (BH, hd)
    torch.testing.assert_close(got[:, :30], mean_v[:, None].expand(
        4, 30, 128), rtol=1e-4, atol=1e-5)
    want = FA.plain(q, k, v, group=2, causal=True, q_offset=0, kv_offset=30)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_wrapper_layout_matches_attention_ref(cuda):
    """``ops.flash_attention_fwd`` on (B, S, H, hd) with GQA against the
    dense ``attention_ref``."""
    from repro_torch.models import attention as A
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    q = torch.randn((2, 50, 8, 64), generator=gen).to(cuda)
    k = torch.randn((2, 50, 2, 64), generator=gen).to(cuda)
    v = torch.randn((2, 50, 2, 64), generator=gen).to(cuda)
    before = FA.launches
    got = K.flash_attention_fwd(q, k, v, causal=True)
    assert FA.launches == before + 1
    want = A.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    with K.plain_versions():
        plain = K.flash_attention_fwd(q, k, v, causal=True)
    assert FA.launches == before + 1
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-4)


def test_flash_attention_wrapper_rejects_what_it_cannot_run(cuda):
    q, k, v = _flash_case(2, 4, 16, 16, 128, 2, torch.float32, cuda)
    with pytest.raises(ValueError):          # K on the CPU
        FA.flash_attention_fwd_p(q, k.cpu(), v, group=2)
    with pytest.raises(ValueError):          # mixed dtypes
        FA.flash_attention_fwd_p(q, k.bfloat16(), v, group=2)
    with pytest.raises(ValueError):          # fp16 is not a kernel dtype
        FA.flash_attention_fwd_p(q.half(), k.half(), v.half(), group=2)
    with pytest.raises(ValueError):          # heads do not group
        FA.flash_attention_fwd_p(q, k, v, group=3)
    with pytest.raises(ValueError):          # hd 96 has no instantiation
        a, b, c = _flash_case(2, 4, 16, 16, 96, 2, torch.float32, cuda)
        FA.flash_attention_fwd_p(a, b, c, group=2)
    with pytest.raises(ValueError):          # not contiguous
        FA.flash_attention_fwd_p(q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), k, v, group=2)
    with pytest.raises(ValueError):          # Hq not a multiple of Hkv
        K.flash_attention_fwd(torch.zeros((1, 4, 3, 64), device=cuda),
                              torch.zeros((1, 4, 2, 64), device=cuda),
                              torch.zeros((1, 4, 2, 64), device=cuda))


# ---------------------------------------------------------------------------
# the expert-stacked delta GEMM (bitlinear_axes_stacked_p) and the delta
# GEMMs at the K of the other archs
# ---------------------------------------------------------------------------

def _stack_case(rng, e, n, k, wdt, device):
    """An expert stack: base, sign planes, even experts row-scaled and odd
    ones col-scaled; returns (payload, scale or None, fp32 base, packed,
    v_row, v_col) on ``device``."""
    wb = torch.from_numpy((rng.standard_normal((e, n, k)) * k ** -0.5
                           ).astype(np.float32)).to(device)
    delta = torch.from_numpy((rng.standard_normal((e, n, k)) * 0.005
                              ).astype(np.float32)).to(device)
    packed = D.pack_signs(D.sign_mask(delta))
    rows = (torch.arange(e, device=device) % 2 == 0)[:, None]
    v_row = torch.where(rows, D.init_scale(delta, "row"), 0.0).half()
    v_col = torch.where(rows, 0.0, D.init_scale(delta, "col")).half()
    wq, ws, wf = _banked_base(wb, wdt)
    return wq, ws, wf, packed, v_row, v_col


def _stacked_within_tolerance(got, x, packed, v_row, v_col, wq, ws, wf):
    """|kernel - plain| <= 1e-5 · Σ_k |x||Ŵ| + 1e-6 per output, Ŵ of the
    row's own expert."""
    want = R.bitlinear_axes_stacked_ref(x.float(), packed, v_row, v_col, wq,
                                        w_scale=ws)
    signs = D.unpack_signs(packed, x.shape[-1])
    w_abs = ((v_row.float()[:, :, None] + v_col.float()[:, None, :]) * signs
             + wf).abs()
    scale = torch.bmm(x.float().abs(), w_abs.transpose(1, 2))
    return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("e", [4, 64])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 17, 64])
@pytest.mark.parametrize("k", [1408, 2048])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.int8)])
def test_bitlinear_axes_stacked_matches_plain(cuda, e, m, k, xdt, wdt):
    """deepseek-moe-16b's expert shapes (w_gate 1408 x 2048, w_down 2048 x
    1408; 1408 is no whole number of the streaming kernel's warp steps):
    one launch for the whole stack, through the streaming kernel (M <= 16)
    and the tiled one, within the GEMM bound of the plain version."""
    n = 2048 if k == 1408 else 1408
    rng = np.random.default_rng(e + m + k)
    wq, ws, wf, packed, v_row, v_col = _stack_case(rng, e, n, k, wdt, cuda)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)
                         ).to(cuda).to(xdt)
    before = BL.stacked_launches
    got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert BL.stacked_launches == before + 1
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    assert _stacked_within_tolerance(got, x, packed, v_row, v_col, wq, ws, wf)


@pytest.mark.parametrize("m", [1, 2, 7, 17, 130])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_bitlinear_axes_stacked_skips_experts_without_rows(cuda, m, wdt):
    """Experts whose rows of x are all zero (one of them -0.0): their
    outputs are exactly 0, and the others equal, bit for bit, a launch of
    the same plan in which those rows hold random values; the live ones
    stay within the GEMM bound of the plain version.  M=130 spans two of
    the tiled kernel's 128-row tiles, the second of which is dead for
    expert 1 only."""
    e, n, k = 6, 260, 1288
    rng = np.random.default_rng(40 + m)
    wq, ws, wf, packed, v_row, v_col = _stack_case(rng, e, n, k, wdt, cuda)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)
                         ).to(cuda).bfloat16()
    dead = [0, 3, 4]
    x[dead] = 0.0
    x[4] = -0.0
    if m > 128:
        x[1, 128:] = 0.0
    got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws)
    filled = x.clone()
    filled[dead] = torch.from_numpy(rng.standard_normal(
        (len(dead), m, k)).astype(np.float32)).to(cuda).bfloat16()
    again = BL.bitlinear_axes_stacked_p(filled, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert not torch.signbit(got[dead]).any()
    live = [1, 2, 5]
    assert torch.equal(got[live], again[live])
    assert _stacked_within_tolerance(got, x, packed, v_row, v_col, wq, ws, wf)
    assert bool((got[live].abs() > 0).any())


@pytest.mark.parametrize("m", [1, 2, 7, 17])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_bitlinear_axes_stacked_partly_zero_slices_are_computed(cuda, m, wdt):
    """A block is skipped only when its whole slice of x is zero: an
    expert with one non-zero element at the end of K, one whose first
    rows are zero, one zero over the first half of K, and one with a NaN
    (not zero: its row's outputs are NaN) are all computed."""
    e, n, k = 4, 96, 2056
    rng = np.random.default_rng(60 + m)
    wq, ws, wf, packed, v_row, v_col = _stack_case(rng, e, n, k, wdt, cuda)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)
                         ).to(cuda).bfloat16()
    x[0] = 0.0
    x[0, -1, -1] = 1.0
    x[1, :-1] = 0.0
    x[2, :, :k // 2] = 0.0
    x[3, 0, 5] = float("nan")
    got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[3, 0]).all())
    assert bool(torch.isfinite(got[:3]).all())
    assert bool((got[0, -1].abs() > 0).all())
    x3 = x.clone()
    x3[3, 0] = 0.0
    keep = torch.ones_like(got, dtype=torch.bool)
    keep[3, 0] = False
    want = R.bitlinear_axes_stacked_ref(x3.float(), packed, v_row, v_col, wq,
                                        w_scale=ws)
    signs = D.unpack_signs(packed, k)
    w_abs = ((v_row.float()[:, :, None] + v_col.float()[:, None, :]) * signs
             + wf).abs()
    scale = torch.bmm(x3.float().abs(), w_abs.transpose(1, 2))
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6)[keep].all())


@pytest.mark.parametrize("m", [1, 2, 4, 17])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_bitlinear_axes_stacked_one_expert_matches_single_kernel(cuda, m, wdt):
    """A stack of one expert against ``bitlinear_axes_p`` on the same
    operands: within the GEMM bound (the two kernels sum in different
    orders)."""
    rng = np.random.default_rng(m)
    wq, ws, wf, packed, v_row, v_col = _stack_case(rng, 1, 260, 1288, wdt,
                                                   cuda)
    x = torch.from_numpy(rng.standard_normal((1, m, 1288)).astype(
        np.float32)).to(cuda)
    got = BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws)
    want = BL.bitlinear_axes_p(x[0], packed[0], v_row[0], v_col[0], wq[0],
                               None if ws is None else ws[0])
    w_abs = ((v_row.float()[0][:, None] + v_col.float()[0][None, :])
             * D.unpack_signs(packed[0], 1288) + wf[0]).abs()
    scale = x[0].abs() @ w_abs.T
    torch.cuda.synchronize()
    assert bool(((got[0] - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_bitlinear_axes_stacked_wrapper_and_refusals(cuda):
    """``ops.bitlinear_axes_stacked`` over a QuantWeight stack: one launch,
    x's dtype out, equal to the plain version within one bf16 step (both
    round an fp32 sum to bf16); the kernel refuses operands it cannot
    run."""
    rng = np.random.default_rng(3)
    wq, ws, _, packed, v_row, v_col = _stack_case(rng, 6, 96, 264,
                                                  torch.int8, cuda)
    x = torch.from_numpy(rng.standard_normal((6, 3, 264)).astype(np.float32)
                         ).to(cuda).bfloat16()
    before = BL.stacked_launches
    got = K.bitlinear_axes_stacked(x, packed, v_row, v_col,
                                   Q.QuantWeight(q=wq, scale=ws))
    torch.cuda.synchronize()
    assert BL.stacked_launches == before + 1 and got.dtype == torch.bfloat16
    with K.plain_versions():
        plain = K.bitlinear_axes_stacked(x, packed, v_row, v_col,
                                         Q.QuantWeight(q=wq, scale=ws))
    assert BL.stacked_launches == before + 1
    torch.testing.assert_close(got.float(), plain.float(), rtol=1e-2,
                               atol=1e-2)
    with pytest.raises(ValueError):          # int8 without its scale
        BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq)
    with pytest.raises(ValueError):          # scale of one matrix
        BL.bitlinear_axes_stacked_p(x, packed, v_row, v_col, wq, ws[0])
    with pytest.raises(ValueError):          # expert counts differ
        BL.bitlinear_axes_stacked_p(x[:5].contiguous(), packed, v_row,
                                    v_col, wq, ws)
    with pytest.raises(ValueError):          # x on the CPU
        BL.bitlinear_axes_stacked_p(x.cpu(), packed, v_row, v_col, wq, ws)


@pytest.mark.parametrize("k", [1408, 2816, 3840, 11008])
@pytest.mark.parametrize("m", [1, 4, 64])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_delta_gemms_at_other_archs_k(cuda, k, m, wdt):
    """``bitlinear_axes_p`` and ``bitlinear_axes_banked_p`` at the K of
    the new archs (expert and shared w_down, gemma3's d_model,
    deepseek-7b's w_down), none a whole number of the int8 warp step (512)
    and 1408 and 2816 not of the fp32 one (256): the GEMM bound against
    the plain versions."""
    n = 96
    rng = np.random.default_rng(k + m)
    wb, packed, v_row, v_col = _bank_case(rng, 4, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda).to(torch.bfloat16)
    got = BL.bitlinear_axes_p(x, packed[1], v_row[1], v_col[1], wq, ws)
    want = R.bitlinear_axes_ref(x.float(), packed[1], v_row[1], v_col[1], wq,
                                w_scale=ws)
    w_abs = ((v_row[1].float()[:, None] + v_col[1].float()[None, :])
             * D.unpack_signs(packed[1], k) + wf).abs()
    scale = x.float().abs() @ w_abs.T
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    vidx = torch.tensor([r % 4 for r in range(m)], dtype=torch.int32,
                        device=cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    torch.cuda.synchronize()
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


def test_moe_combine_repeats_bit_for_bit(cuda):
    """The MoE combine (``moe._combine``) over a deepseek-moe-16b-sized
    prefill dispatch (64 tokens, 64 experts, top-6, capacity 7) in bf16:
    two runs on the card are equal bit for bit, and agree with the same
    combine on the CPU within one bf16 step."""
    from repro_torch.models import moe as M
    g, n, e, k, cap, d = 1, 64, 64, 6, 7, 2048
    gen = torch.Generator().manual_seed(4)
    probs = torch.softmax(torch.randn((g, n, e), generator=gen), -1)
    top_val, top_idx = M.top_k(probs, k)
    sel = torch.nn.functional.one_hot(top_idx, e).float() * top_val[..., None]
    c_val, c_idx = M.top_k(sel.sum(2).transpose(1, 2), cap)
    yd = (torch.randn((g, e, cap, d), generator=gen)
          * c_val[..., None]).to(torch.bfloat16)
    got = M._combine(yd.to(cuda), c_idx.to(cuda), top_idx.to(cuda))
    again = M._combine(yd.to(cuda), c_idx.to(cuda), top_idx.to(cuda))
    assert torch.equal(got, again)
    want = M._combine(yd, c_idx, top_idx).float()
    assert bool(((got.cpu().float() - want).abs()
                 <= 2 ** -7 * want.abs() + 1e-6).all())


def _device_bank(gen, nbank, n, k, device):
    """``_bank_case`` drawn on the card (the large shapes below): slot 0
    zero, odd slots row-scaled, even slots col-scaled."""
    wb = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
    packed = torch.zeros((nbank, n, k // 8), dtype=torch.uint8, device=device)
    v_row = torch.zeros((nbank, n), device=device)
    v_col = torch.zeros((nbank, k), device=device)
    for s in range(1, nbank):
        delta = torch.randn((n, k), generator=gen, device=device) * 0.005
        packed[s] = D.pack_signs(D.sign_mask(delta))
        if s % 2:
            v_row[s] = D.init_scale(delta, "row")
        else:
            v_col[s] = D.init_scale(delta, "col")
        del delta
    return wb, packed, v_row.half(), v_col.half()


def _lanes(slots, rows, device):
    """Per-row slots of a continuous prefill: lane i's ``rows`` rows on
    ``slots[i]``."""
    return torch.tensor(slots, dtype=torch.int32,
                        device=device).repeat_interleave(rows)


@pytest.mark.parametrize("nk", [(512, 512), (2048, 512), (512, 2048)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_delta_gemms_at_whisper_prefill_rows(cuda, nk, wdt):
    """whisper-base's encoder projections and the cross-attention's wk/wv
    take 4 lanes x 1500 frames = 6000 rows: ``bitlinear_axes_p`` and the
    banked GEMM (lanes on slots [0, 1, 2, 1], so 64-row tiles straddle two
    slots at lane edges) against their plain versions, the GEMM bound."""
    n, k = nk
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    wb, packed, v_row, v_col = _device_bank(gen, 3, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    x = torch.randn((6000, k), generator=gen, device=cuda).to(torch.bfloat16)
    got = BL.bitlinear_axes_p(x, packed[1], v_row[1], v_col[1], wq, ws)
    want = R.bitlinear_axes_ref(x.float(), packed[1], v_row[1], v_col[1], wq,
                                w_scale=ws)
    w_abs = ((v_row[1].float()[:, None] + v_col[1].float()[None, :])
             * D.unpack_signs(packed[1], k) + wf).abs()
    assert bool(((got - want).abs()
                 <= 1e-5 * (x.float().abs() @ w_abs.T) + 1e-6).all())
    vidx = _lanes([0, 1, 2, 1], 1500, cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_banked_gemm_at_internvl2_w_down(cuda, wdt):
    """internvl2-76b's w_down (8192 x 28672) in a continuous prefill: 4
    lanes x (256 image + 32 text) = 1152 rows over a 3-slot bank, lanes on
    [0, 1, 2, 1]; K = 28672 splits into 56 partial sums (a (56, 1152,
    8192) fp32 workspace): the GEMM bound against the plain version."""
    n, k = 8192, 28672
    gen = torch.Generator(device=cuda).manual_seed(7)
    wb, packed, v_row, v_col = _device_bank(gen, 3, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    del wb
    x = torch.randn((1152, k), generator=gen, device=cuda).to(torch.bfloat16)
    vidx = _lanes([0, 1, 2, 1], 288, cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("nk", [(8, 2048), (112, 3584), (128, 3584),
                                (1024, 1344)])
@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_delta_gemms_at_recurrent_shapes(cuda, nk, m, wdt):
    """The recurrent families' narrowest N and their odd K: xlstm's mLSTM
    w_if (8 x 2048), zamba's w_dt (112 x 3584) and w_bc (128 x 3584), and
    xlstm's w_ff2 (1024 x 1344: K no whole number of 256), at a decode
    step's 4 rows and a 4 x 16 prefill's 64: ``bitlinear_axes_p`` and the
    banked GEMM (lanes on slots [0, 1, 2, 1]) against their plain
    versions, the GEMM bound."""
    n, k = nk
    gen = torch.Generator(device=cuda).manual_seed(n + k + m)
    wb, packed, v_row, v_col = _device_bank(gen, 3, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    for s in (1, 2):                        # a row-scaled and a col-scaled
        got = BL.bitlinear_axes_p(x, packed[s], v_row[s], v_col[s], wq, ws)
        want = R.bitlinear_axes_ref(x.float(), packed[s], v_row[s],
                                    v_col[s], wq, w_scale=ws)
        w_abs = ((v_row[s].float()[:, None] + v_col[s].float()[None, :])
                 * D.unpack_signs(packed[s], k) + wf).abs()
        assert bool(((got - want).abs()
                     <= 1e-5 * (x.float().abs() @ w_abs.T) + 1e-6).all())
    vidx = _lanes([0, 1, 2, 1], m // 4, cuda)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("use_row", [True, False])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_dense_load_of_an_unstacked_entry(cuda, use_row, wdt):
    """zamba's shared block: a 2-D target whose ``use_row`` has rank 0.
    The loader's dense reconstruction (``unpack_apply`` in row and col
    mode, then the select) launches two kernels and equals, bit for bit,
    the same reconstruction on the CPU through the plain versions."""
    from repro_torch.core import loader as L
    from repro_torch.core.calibration import DeltaEntry
    rng = np.random.default_rng(int(use_row))
    wb, packed, delta = _delta_case(rng, (), 448, 896, "cpu")
    entry = DeltaEntry(packed=packed, v_row=D.init_scale(delta, "row"),
                       v_col=D.init_scale(delta, "col"),
                       use_row=torch.tensor(use_row))
    w = Q.quantize_weight(wb) if wdt == torch.int8 else wb
    want = L._reconstruct_entry(entry, w, use_kernel=True)
    on_card = DeltaEntry(packed=packed.to(cuda), v_row=entry.v_row.to(cuda),
                         v_col=entry.v_col.to(cuda),
                         use_row=entry.use_row.to(cuda))
    before = UA.launches
    got = L._reconstruct_entry(on_card, Q.QuantWeight(
        q=w.q.to(cuda), scale=w.scale.to(cuda)) if wdt == torch.int8
        else w.to(cuda), use_kernel=True)
    assert UA.launches == before + 2
    assert got.shape == (448, 896) and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k_draft", [1, 2, 4])
@pytest.mark.parametrize("wdt", [torch.float32, torch.int8])
def test_banked_gemm_in_the_speculative_verify_layout(cuda, k_draft, wdt):
    """A verify round of draft length k over 4 lanes on slots [0, 1, 2, 1]
    (``ops.flatten_vidx`` of a (4, k+1) token batch: each lane's k+1 rows
    together), M = 8, 12 and 20 (20 takes the tiled kernel), at
    qwen3-8b's wq shape (4096 x 4096): the GEMM bound against the plain
    version."""
    n, k = 4096, 4096
    gen = torch.Generator(device=cuda).manual_seed(k_draft)
    wb, packed, v_row, v_col = _device_bank(gen, 3, n, k, cuda)
    wq, ws, wf = _banked_base(wb, wdt)
    lanes = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=cuda)
    vidx = K.flatten_vidx(lanes, (4, k_draft + 1))
    assert torch.equal(vidx, _lanes([0, 1, 2, 1], k_draft + 1, cuda))
    x = torch.randn((4 * (k_draft + 1), k), generator=gen,
                    device=cuda).to(torch.bfloat16)
    got = BL.bitlinear_axes_banked_p(x, vidx, packed, v_row, v_col, wq, ws)
    assert _banked_within_tolerance(got, x, vidx, packed, v_row, v_col, wf)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "xlstm-350m"])
def test_verify_step_through_the_kernels_matches_plain(cuda, arch):
    """A reduced verify (fp32 compute) of 5 tokens a lane over a 4-slot
    bank, lanes on [0, v0, v1, v0]: from one cache, the logits through the
    kernels within 1e-3 of the plain versions' with the same greedy
    tokens; the banked kernel launched (20 rows a projection; the
    recurrent verify steps 5 times)."""
    import copy
    import dataclasses

    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving.variants import OverlayBank

    cfg = dataclasses.replace(SV.make_config(arch, reduced=True),
                              compute_dtype="float32")
    model = build_model(cfg)
    base, _ = split(model.init(0, device=cuda))
    bank = OverlayBank(base, 4)
    slots = [bank.admit(f"v{i}", C.compress(
        base, SV.fine_tune(base, 100 + i, 0.05)))[0] for i in range(2)]
    vidx = torch.tensor([0, slots[0], slots[1], slots[0]],
                        dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (4, 8), generator=gen,
                           device=cuda)
    seq = torch.randint(1, cfg.vocab_size, (4, 5), generator=gen,
                        device=cuda)
    with K.plain_versions():
        _, cache = model.prefill(base, {"tokens": prompt}, 32,
                                 cache_dtype=torch.float32,
                                 overlay=bank.tree, variant_idx=vidx)
    before = BL.banked_launches
    got, _ = model.verify_step(base, seq, copy.deepcopy(cache),
                               overlay=bank.tree, variant_idx=vidx)
    torch.cuda.synchronize()
    assert BL.banked_launches > before
    with K.plain_versions():
        want, _ = model.verify_step(base, seq, copy.deepcopy(cache),
                                    overlay=bank.tree, variant_idx=vidx)
    assert got.shape == (4, 5, cfg.padded_vocab)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


# ---------------------------------------------------------------------------
# compile-once serving: CUDA-graph replay of the slot scheduler's steps
# ---------------------------------------------------------------------------

def _counts():
    return {"banked": BL.banked_launches, "stacked": BL.stacked_launches,
            "axes": BL.launches, "static": BL.static_launches,
            "unpack": UA.launches, "flash": FA.launches}


def _graph_deployment(arch, device, graphs, **kw):
    """A reduced ``arch`` (its reduced depth) over ``device`` with two
    published variants (fine-tunes at 0.05) and the requests of
    ``_graph_requests``."""
    from repro_torch.launch import serve as SV

    cfg = SV.make_config(arch, reduced=True)
    model, base, dms = SV.build_variants(cfg, 2, device)
    return SV.deploy(model, base, dms, mode="fused", batch=4, bank_size=4,
                     device=device, graphs=graphs, draft_k=4, **kw), cfg


def _graph_serve(dep, cfg):
    from repro_torch.launch import serve as SV
    rids = SV.submit_requests(dep, cfg, 10, [3, 7, 5, 9])
    dep.drain()
    torch.cuda.synchronize()
    return [dep.result(r).out_tokens for r in rids]


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "whisper-base", "xlstm-350m", "zamba2-7b"])
@pytest.mark.parametrize("scheduler", ["continuous", "speculative"])
@pytest.mark.parametrize("base_dtype", ["fp", "int8"])
def test_graph_tokens_equal_eager_tokens(cuda, arch, scheduler, base_dtype):
    """The same requests served with every decode step (or round) replayed
    from a CUDA graph and served eagerly: tokens equal bit for bit, the
    same kernel launches counted (a replay adds what its capture
    recorded), one replay a step and no capture after ``warmup()``."""
    runs = {}
    for graphs in (True, False):
        dep, cfg = _graph_deployment(arch, cuda, graphs, scheduler=scheduler,
                                     base_dtype=base_dtype)
        if graphs:
            outcomes = dep.warmup()
            assert "captured" in outcomes.values()
        steps0 = dict(dep.status()["steps"])
        before = _counts()
        tokens = _graph_serve(dep, cfg)
        after = _counts()
        steps = dep.status()["steps"]
        m = dep.metrics
        runs[graphs] = (tokens, {k: after[k] - before[k] for k in after})
        assert dep.engine.graphs == graphs
        assert steps["compiles"] == steps0["compiles"]
        assert steps["cache_hits"] - steps0["cache_hits"] == (
            m["decode_steps"] if graphs else 0)
        del dep
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    assert runs[True][1]["banked"] > 0


def test_replay_after_the_banks_reservation_hits(cuda):
    """``warmup()`` captures the banked step against the reserved bank;
    the first admit writes into it, so serving replays that graph without
    a capture, and a second warmup finds every graph held."""
    dep, cfg = _graph_deployment("qwen3-8b", cuda, True,
                                 scheduler="continuous")
    outcomes = dep.warmup()
    assert outcomes["banked/decode_banked"] == "captured"
    assert outcomes["banked-empty/decode_banked"] == "captured"
    bank = dep.registry.bank
    assert bank.tree is None
    compiles = dep.status()["steps"]["compiles"]
    _graph_serve(dep, cfg)
    assert bank.tree is bank._tree and bank.stats["admits"] > 0
    assert dep.status()["steps"]["compiles"] == compiles
    again = dep.warmup()
    assert "captured" not in again.values()
    assert again["banked/decode_banked"] == "hit"


def test_a_capture_that_syncs_raises(cuda, monkeypatch):
    """A decode step that waits for the device cannot be captured:
    ``warmup()`` raises and no eager step stands in for the graph."""
    from repro_torch.models import transformer

    decode = transformer.decode_step

    def syncing(params, token, cache, cfg, **kw):
        token.sum().item()
        return decode(params, token, cache, cfg, **kw)

    dep, _ = _graph_deployment("qwen3-8b", cuda, True,
                               scheduler="continuous")
    monkeypatch.setattr(transformer, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        dep.warmup()
    assert ("banked-empty", "decode_banked") not in dep.engine._graphs
    assert dep.status()["steps"]["compiles"] == 0
    torch.cuda.synchronize()


def test_moved_addresses_are_captured_again(cuda):
    """A graph replays the addresses it was captured on: when the base's
    tensors move (a copy of the same values), the next step captures
    again instead of replaying stale addresses, with the same tokens."""
    from repro_torch.tree import tree_map

    runs = []
    for move in (False, True):
        dep, cfg = _graph_deployment("qwen3-8b", cuda, True,
                                     scheduler="continuous")
        dep.warmup()
        compiles = dep.status()["steps"]["compiles"]
        if move:
            dep.registry.base_params = tree_map(torch.clone,
                                                dep.registry.base_params)
        runs.append(_graph_serve(dep, cfg))
        recaptured = dep.status()["steps"]["compiles"] - compiles
        assert (recaptured > 0) == move, recaptured
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# async admission: staged transfers on a side stream, the commit's wait on
# their events, pinned buffers, capture while a ticket stages
# ---------------------------------------------------------------------------

def _host_delta_model(seed: int, rows: int = 64, extra_rows: int = 1000):
    """A small DeltaModel of host tensors: one stacked entry and one fp16
    extra."""
    from repro_torch.core.calibration import DeltaEntry, DeltaModel
    g = torch.Generator().manual_seed(seed)
    entry = DeltaEntry(
        packed=torch.randint(0, 256, (2, rows, 32), dtype=torch.uint8,
                             generator=g),
        v_row=torch.randn(2, rows, generator=g),
        v_col=torch.randn(2, 256, generator=g),
        use_row=torch.tensor([True, False]))
    return DeltaModel(deltas={"layers.attn.wq": entry},
                      extras={"embed": torch.randn(extra_rows, 64,
                                                   generator=g).half()})


def test_staged_transfers_equal_their_host_source(cuda):
    """Each module's copies, in pinned chunks on a side stream, hold the
    host source's bytes once its event has completed."""
    from repro_torch.core import loader as L
    from repro_torch.core import store as S

    dm = _host_delta_model(0)
    pool = S.StagingPool(pin_memory=True)
    staged, futures = L.stage_overlay_transfer(
        dm, device=cuda, stream=torch.cuda.Stream(), pool=pool,
        chunk_bytes=4096)
    L.wait_transfers(futures)
    assert [f.path for f in futures] == ["layers.attn.wq", "embed"]
    assert all(f.event is not None and f.event.query() for f in futures)
    e, got = dm.deltas["layers.attn.wq"], staged.deltas["layers.attn.wq"]
    for f in ("packed", "v_row", "v_col", "use_row"):
        assert getattr(got, f).is_cuda
        assert torch.equal(getattr(got, f).cpu(), getattr(e, f))
    assert torch.equal(staged.extras["embed"].cpu(), dm.extras["embed"])
    # 128 KB of extras in 4 KB chunks through at most two pinned buffers
    assert pool.stats["peak_bytes"] <= 2 * 4096
    assert pool.stats["reuses"] == pool.stats["takes"] - \
        pool.stats["peak_bytes"] // 4096


def test_a_commit_waits_for_its_staging_copies(cuda):
    """A module staged behind a long side-stream kernel and committed at
    once: the bank's writes wait on the staging event, so the slot holds
    the bytes a synchronous admit writes.  Every allocation the commit
    and the staging make is cached and every kernel the commit launches
    loaded beforehand: a ``cudaMalloc``, a pinned allocation or a lazy
    module load between the copy and the commit would order the two
    streams by itself and hide a missing wait."""
    from repro_torch.core import loader as L
    from repro_torch.core import store as S
    from repro_torch.core.calibration import DeltaModel
    from repro_torch.serving.variants import OverlayBank

    base = {"big": torch.zeros(4096, 8192, device=cuda)}
    g = torch.Generator().manual_seed(1)
    dm = DeltaModel(deltas={}, extras={
        "big": torch.randn(4096, 8192, generator=g).half()})
    sync = OverlayBank(base, 2)
    slot_payload = sync.admit("v", dm)          # its temporaries now cached
    # the commit's fp16 -> fp32 cast, launched once at the same shape
    torch.zeros(4096, 8192, dtype=torch.float16, device=cuda).float()
    bank = OverlayBank(base, 2)
    bank.reserve()
    pool = S.StagingPool(pin_memory=True)
    pool.give(pool.take((128 << 20,), torch.uint8))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.zeros(4096, 8192, dtype=torch.float16, device=cuda)
        torch.cuda._sleep(int(1e9))         # the copy queues behind this
    staged, futures = L.stage_overlay_transfer(
        dm, device=cuda, stream=side, pool=pool, chunk_bytes=128 << 20)
    assert not futures[0].event.query()
    slot, payload, fence = bank.admit_async("v", staged, futures)
    fence()
    assert (slot, payload) == slot_payload
    torch.cuda.synchronize()
    assert torch.equal(bank._flat["big"][slot], sync._flat["big"][slot])
    assert torch.equal(bank._flat["big"][slot].cpu(),
                       dm.extras["big"].float())


def test_a_pinned_buffer_waits_for_its_copy(cuda):
    """A buffer given back with the event of a copy still running is not
    handed out before that event completes: with room in its class the
    pool hands out another buffer, with its class full it waits."""
    from repro_torch.core import store as S

    n = 64 << 20
    dst = torch.empty(n, dtype=torch.uint8, device=cuda)
    for max_buffers in (2, 1):
        pool = S.StagingPool(max_buffers=max_buffers, pin_memory=True)
        buf = pool.take((n,), torch.uint8)
        assert buf.is_pinned()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(1e9))
            dst.copy_(buf, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        pool.give(buf, event=copied, live=(dst,))
        assert not copied.query()
        again = pool.take((n,), torch.uint8)
        if max_buffers == 2:
            assert again.data_ptr() != buf.data_ptr()
            assert pool.stats["waits"] == 0
        else:
            assert copied.query() and again.data_ptr() == buf.data_ptr()
            assert pool.stats["waits"] == 1
        torch.cuda.synchronize()


def _admission_deployment(device, root, async_admission):
    """Reduced qwen3-8b over a store under ``root`` (two published
    variants, graphs on) and the fine-tune its update publishes."""
    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV

    cfg = SV.make_config("qwen3-8b", reduced=True)
    model, base, dms = SV.build_variants(cfg, 2, device)
    dep = SV.deploy(model, base, dms, mode="fused", scheduler="continuous",
                    batch=4, bank_size=4, device=device, root_dir=root,
                    async_admission=async_admission)
    return dep, cfg, C.compress(base, SV.fine_tune(base, 300))


def test_async_run_after_warmup_captures_nothing(cuda, tmp_path):
    """Warm traffic (the bank in place), ``warmup()``, then a run during
    which an update is published, ingested and committed between steps:
    the async run captures nothing, replays one graph a step and emits
    the synchronous run's tokens bit for bit."""
    from repro_torch.launch import serve as SV

    runs = {}
    for mode in ("sync", "async"):
        dep, cfg, update = _admission_deployment(cuda, tmp_path / mode,
                                                 mode == "async")
        for v in ("v0", "v1"):
            dep.submit(np.arange(1, 9), variant=v, max_new_tokens=1)
        dep.drain()
        dep.warmup()
        steps0, m0 = dict(dep.status()["steps"]), dict(dep.metrics)
        before = _counts()
        rids = SV.submit_requests(dep, cfg, 2, 12)
        dep.drain(max_steps=2)
        dep.update("v0", update)
        rids += [dep.submit(np.arange(3, 11), variant=v, max_new_tokens=6)
                 for v in ("v0", "v1")]
        dep.drain()
        torch.cuda.synchronize()
        steps, m = dep.status()["steps"], dep.metrics
        assert steps["compiles"] == steps0["compiles"], (steps0, steps)
        assert steps["cache_hits"] - steps0["cache_hits"] == \
            m["decode_steps"] - m0["decode_steps"]
        assert m["async_admits"] - m0["async_admits"] == (
            1 if mode == "async" else 0)
        assert dep.status(rids[2])["version"] == 2
        # the async run serves more steps (its variant requests wait for
        # their commit), each with the banked launches of an eager one
        launched = {k: v - before[k] for k, v in _counts().items()}
        assert launched["banked"] == 28 * (
            m["prefills"] - m0["prefills"] + m["decode_steps"]
            - m0["decode_steps"]) > 0, launched
        runs[mode] = [dep.result(r).out_tokens for r in rids]
        dep.close()
    assert runs["async"] == runs["sync"]


def test_a_capture_while_a_ticket_stages_is_clean(cuda, tmp_path,
                                                  monkeypatch):
    """The engine captures its graphs again and again while the admission
    worker stages (pinned and device allocations, copies and event waits
    on its stream): every capture succeeds, and the run after it emits
    the tokens of a deployment that never staged during a capture."""
    import threading

    from repro_torch.core import loader as L
    from repro_torch.core import store as S
    from repro_torch.launch import serve as SV

    real = L.stage_overlay_transfer
    staging, stop = threading.Event(), threading.Event()

    def storm(dm, **kw):
        i = 0
        while not stop.is_set():
            staging.set()
            junk = torch.empty(((i % 8) + 1) << 20, dtype=torch.uint8,
                               pin_memory=True)
            _, fut = real(type(dm)(deltas={}, extras={"junk": junk}),
                          device=kw["device"], stream=kw["stream"],
                          pool=S.StagingPool(pin_memory=True),
                          chunk_bytes=256 << 10)
            L.wait_transfers(fut)
            i += 1
        return real(dm, **kw)

    tokens = {}
    for mode in ("plain", "storm"):
        dep, cfg, _ = _admission_deployment(cuda, tmp_path / mode, True)
        if mode == "storm":
            stop.clear()
            monkeypatch.setattr(L, "stage_overlay_transfer", storm)
        dep.publish("v2", dep.store.load("v0", 1))
        if mode == "storm":
            assert staging.wait(60)
        for _ in range(3):
            dep.engine._graphs.clear()
            outcomes = dep.warmup()
            assert "captured" in outcomes.values()
        stop.set()
        dep.admission.wait(timeout=120)
        monkeypatch.setattr(L, "stage_overlay_transfer", real)
        compiles = dep.status()["steps"]["compiles"]
        rids = SV.submit_requests(dep, cfg, 8, [3, 6])
        dep.drain()
        assert dep.status()["steps"]["compiles"] == compiles
        tokens[mode] = [dep.result(r).out_tokens for r in rids]
        dep.close()
    assert tokens["storm"] == tokens["plain"]


# ---------------------------------------------------------------------------
# the training side on the card against the same code on the CPU: the
# RMSNorm and flash backward passes (max |diff| within 1e-5 of the
# tensor's largest entry in fp32, one bf16 step, 2^-7, of it in bf16: sums
# in another order, and in bf16 a rounding of an intermediate such as p or
# dS may flip by one step, which moves its products at the scale of the
# tensor, not of the element), a reduced train step (losses within 1e-5 rel,
# params within 1e-3 abs after 3 Adam steps at lr 5e-3), and a checkpoint
# written from the card restoring bit for bit on the CPU
# ---------------------------------------------------------------------------

def _grads_close(got, want, dtype):
    got, want = got.detach().cpu().float(), want.detach().float()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert (got - want).abs().max() <= tol * want.abs().max()


def _backward(fn, inputs, dout, device):
    leaves = [t.detach().to(device).requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out.backward(dout.to(device))
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale_shape", [((2, 64, 4096), (4096,)),
                                               ((2, 64, 32, 128), (128,)),
                                               ((2, 8, 4, 16), (4, 16))])
def test_rmsnorm_backward_card_matches_cpu(cuda, dtype, shape, scale_shape):
    from repro_torch.models import layers as LY
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(dtype)
    scale = 1 + 0.1 * torch.randn(scale_shape, generator=gen)
    dy = torch.randn(shape, generator=gen).to(dtype)

    def fn(a, s):
        return LY.rmsnorm(a, s, 1e-6)
    want_y, want = _backward(fn, (x, scale), dy, "cpu")
    got_y, got = _backward(fn, (x, scale), dy, cuda)
    _grads_close(got_y, want_y, dtype)
    _grads_close(got[0], want[0], dtype)
    _grads_close(got[1], want[1], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [dict(causal=True), dict(causal=False),
                                  dict(causal=True, window=100, chunk=64),
                                  dict(causal=True, kv_offset=64, chunk=64),
                                  dict(causal=True, q_offset=128, chunk=128)])
def test_flash_backward_card_matches_cpu(cuda, dtype, case):
    from repro_torch.models import attention as AT
    gen = torch.Generator().manual_seed(1)
    b, s, t, hq, hkv, hd = 1, 128, 256 if "q_offset" in case else 128, \
        32, 8, 128
    q = torch.randn((b, s, hq, hd), generator=gen).to(dtype)
    k = torch.randn((b, t, hkv, hd), generator=gen).to(dtype)
    v = torch.randn((b, t, hkv, hd), generator=gen).to(dtype)
    do = torch.randn((b, s, hq, hd), generator=gen).to(dtype)

    def fn(*a):
        return AT.flash_attention(*a, **case)
    want_o, want = _backward(fn, (q, k, v), do, "cpu")
    got_o, got = _backward(fn, (q, k, v), do, cuda)
    _grads_close(got_o, want_o, dtype)
    for g, w in zip(got, want):
        _grads_close(g, w, dtype)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b"])
def test_train_steps_card_match_cpu(cuda, arch, tmp_path):
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch.checkpoint.manager import CheckpointManager, _flat
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), num_layers=2,
                              compute_dtype="float32")
    model = build_model(cfg)
    init = TS.init_train_state(model, 0, "cpu")
    src = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [src.lm_batch(i, 2, 32) for i in range(3)]
    out = {}
    for where in ("cpu", cuda):
        state = dataclasses.replace(init, params=tree_map(
            lambda t: t.to(where), init.params), opt=TS.adamw_init(
                tree_map(lambda t: t.to(where), init.params)))
        step = TS.make_train_step(model, peak_lr=5e-3, warmup=2,
                                  total_steps=10)
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        out[str(where)] = (losses, state)
    (cpu_l, cpu_s), (card_l, card_s) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-5)
    for k, a in _flat(card_s.params).items():
        torch.testing.assert_close(a.cpu(), _flat(cpu_s.params)[k], rtol=0,
                                   atol=1e-3)
    CheckpointManager(tmp_path).save(3, card_s)
    step, restored = CheckpointManager(tmp_path).restore_latest(cpu_s)
    assert step == 3
    for k, a in _flat(card_s).items():
        b = _flat(restored)[k]
        if isinstance(a, torch.Tensor):
            assert b.device.type == "cpu" and torch.equal(a.cpu(), b), k
        else:
            assert a == b, k


# ---------------------------------------------------------------------------
# mesh-sharded serving on the card (ranks spawned by launch.mesh: NCCL when
# every rank has a card of its own, else gloo over card 0)
# ---------------------------------------------------------------------------

def _mesh_data(path) -> str:
    """Reduced deepseek-7b and deepseek-moe-16b weights, two synthetic
    variants each and the requests, in the rank-side exchange file
    (``tests/_mesh_ranks.py``); made by the port alone."""
    import pickle

    import _mesh_ranks as MR
    from repro_torch import bridge
    from repro_torch.core import calibration as C
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    data = {}
    for arch in ("deepseek-7b", "deepseek-moe-16b"):
        cfg = MR.port_config(arch)
        base, _ = split(build_model(cfg).init(0, device="cpu"))
        dms = [C.compress(base, SV.fine_tune(base, 41 + i, scale=0.05))
               for i in range(2)]
        rng = np.random.default_rng(3)
        data[arch] = {
            "flat": bridge.params_to_numpy(base),
            "dms": [bridge.delta_model_to_numpy(d) for d in dms],
            "prompts": [rng.integers(1, cfg.vocab_size, size=n)
                        for n in (12, 7, 10, 12, 5, 9)],
            "tokens": rng.integers(1, cfg.vocab_size, size=(MR.BATCH, 10))}
    out = str(path / "mesh.pkl")
    with open(out, "wb") as f:
        pickle.dump(data, f)
    return out


def test_mesh_dispatch_per_rank_matches_single_card_kernel(cuda, tmp_path):
    """Each rank's kernels (row- and column-sharded wq / wo / w_down, the
    banked GEMM over three slots, the expert stacks over its local experts,
    ``unpack_apply`` per tile; per rank and gathered) on a (1, 2) mesh
    against the single-card kernel on the whole operands."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as LM
    import _mesh_ranks as MR
    build.library()          # built before any rank starts
    path = _mesh_data(tmp_path)
    got = LM.spawn(MR.run, (1, 2), device="cuda", timeout_s=600,
                   args=(path, {"dispatch": True}))
    for g in got:
        assert g["device"].startswith("cuda")
        for name, ratio in g["dispatch"].items():
            if name.startswith("unpack"):
                assert ratio == 0.0, name
            else:
                assert ratio <= 1.0, (name, ratio)


def test_mesh_deployment_on_card_matches_cpu(cuda, tmp_path):
    """A (1, 2) Deployment on the card serves the single-process CPU plain
    path's tokens on every rank: continuous banked, group fused and group
    dense, per-rank and gathered kernels."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as LM
    import _mesh_ranks as MR
    build.library()
    path = _mesh_data(tmp_path)
    data = MR.load(path)
    archs = ("deepseek-7b", "deepseek-moe-16b")
    plan = {"tokens": {a: tuple(MR.SCHEDULERS) for a in archs}}
    got = LM.spawn(MR.run, (1, 2), device="cuda", timeout_s=900,
                   args=(path, plan))
    for arch in archs:
        want = MR.mesh_tokens(None, arch, data[arch], kds=("shard_map",))
        for g in got:
            for (kd, sched), toks in g[("tokens", arch)].items():
                assert toks == want[("shard_map", sched)], (arch, kd, sched)


def test_mesh_refuses_graphs_on_the_card(cuda):
    """A gloo collective cannot be captured in a CUDA graph: a mesh
    Deployment on the card with graphs=True raises, naming the slice."""
    import _mesh_ranks as MR
    from repro_torch.distributed import sharding as S
    from repro_torch.models import build_model
    from repro_torch.models.param import split
    from repro_torch.serving import Deployment
    model = build_model(MR.port_config("deepseek-7b"))
    params, axes = split(model.init(0, device="cpu"))
    with pytest.raises(NotImplementedError, match="graphs.*slice"):
        Deployment(model, params, device=cuda, param_axes=axes,
                   mesh=S.Mesh(("data", "model"), (1, 2), device=cuda))


MESH_TRAIN_ARCHS = ("deepseek-7b", "deepseek-moe-16b")


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=["1x2", "2x1", "2x2", "1x4"])
def test_mesh_train_on_card_matches_cpu(cuda, tmp_path, shape):
    """``make_train_step(param_axes=)`` under the train rules on the card
    (ranks on card 0 over gloo): every rank's metrics, gathered step-1
    gradients and final params within the mesh-training bar
    (``_mesh_ranks.assert_train_matches``) of the single-process CPU
    plain run from the same params and batches.  deepseek-7b and
    deepseek-moe-16b on (1, 2), (2, 1), (2, 2), with whisper-base,
    internvl2-76b, xlstm-350m and zamba2-7b on (1, 2) and (2, 2); on
    (1, 4) reduced qwen3-8b (the GQA layout), the head-cut cases and the
    6-head starcoder2-3b ("whole"); the recurrent families' later
    metrics or step-1 gradients to ``TRAIN_LIMITS_CARD``."""
    import pickle

    from repro_torch.launch import mesh as LM
    import _mesh_family_ranks as MF
    import _mesh_ranks as MR
    fams = {(1, 2): MF.ARCHS, (2, 2): MF.ARCHS,
            (1, 4): MF.TRAIN_QUAD}.get(shape, ())
    cases = {a: (MR.run, None) for a in (
        ("qwen3-8b",) if shape == (1, 4) else MESH_TRAIN_ARCHS)}
    cases.update({c: (MF.run, MF.TRAIN_FIELDS[c]) for c in fams})
    data = {f"train {c}": MR.port_train_data(MF.arch_of(c), f)
            for c, (_, f) in cases.items()}
    path = str(tmp_path / "train.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    for run in dict.fromkeys(r for r, _ in cases.values()):
        mine = tuple(c for c, (r, _) in cases.items() if r is run)
        got = LM.spawn(run, shape, device="cuda", timeout_s=900,
                       args=(path, {"train": mine}))
        for c in mine:
            want = MR.mesh_train(None, data[f"train {c}"], MF.arch_of(c),
                                 fields=cases[c][1])
            for g in got:
                MR.assert_train_matches(
                    g[("train", c)], want,
                    MF.TRAIN_LIMITS_CARD.get(c, (1e-5, 1e-5)))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_sharded_rmsnorm_backward_on_card_matches_whole(cuda, shape):
    """``layers.rmsnorm(part=)`` under grad on card ranks (gloo): each
    rank's ``dx`` and ``dscale`` within 1e-6 of its blocks of the whole
    norm's gradients on the card (relative to their largest |value|), and
    its forward without grad bit-identical to the forward-only formula."""
    from repro_torch.launch import mesh as LM
    import _mesh_family_ranks as MF
    for g in LM.spawn(MF.rmsnorm_grad_check, shape, device="cuda",
                      timeout_s=300):
        assert g["device"].startswith("cuda")
        assert g["dx"] < 1e-6 and g["dscale"] < 1e-6, g
        assert g["forward bits"], g


# ---------------------------------------------------------------------------
# an int8 base under a mesh: the q8 bodies on a rank's blocks
# ---------------------------------------------------------------------------

def _rank_block(t, spec, coord):
    """Rank ``coord``'s block of ``t`` on a (1, 2) mesh (contiguous)."""
    from repro_torch.distributed import sharding as S
    mesh = S.Mesh(("data", "model"), (1, 2), coords=(0, coord))
    return S.block(t, spec, mesh)


@pytest.mark.parametrize("tile", ["k", "n"])
@pytest.mark.parametrize("coord", [0, 1])
@pytest.mark.parametrize("body", ["unpack_apply", "bitlinear_axes",
                                  "bitlinear_axes_banked",
                                  "bitlinear_axes_stacked"])
def test_q8_bodies_on_a_rank_block_match_plain(cuda, body, tile, coord):
    """Each q8 body on one rank's block of a globally quantized weight: a
    K-tile (the in dim sharded: the whole rows' scales beside the rank's
    columns) or an N-tile (its rows' payload and scales), cut as
    ``sharding.block`` places them, against the plain version on the same
    local operands; ``unpack_apply`` bit for bit, the GEMMs within the
    GEMM bound."""
    from repro_torch.models import delta_overlay as DO
    rng = np.random.default_rng(40 + coord)
    e, n, k, m = 4, 256, 1024, 4
    lead = (e,) if body == "bitlinear_axes_stacked" else ()
    wb, packed, delta = _delta_case(rng, lead, n, k, cuda)
    qw = Q.quantize_weight(wb)                       # the global bytes
    spec = (None,) * len(lead) + ((None, "model") if tile == "k"
                                  else ("model", None))
    sp = DO.entry_shardings_from_weight(spec, len(spec))
    q_l, s_l = (_rank_block(qw.q, spec, coord),
                _rank_block(qw.scale, spec[:-1], coord))
    assert s_l.is_contiguous() and q_l.data_ptr() % 8 == 0
    p_l = _rank_block(packed, sp.packed, coord)
    vr = _rank_block(D.init_scale(delta, "row").half(), sp.v_row, coord)
    vc = _rank_block(D.init_scale(delta, "col").half(), sp.v_col, coord)
    kl = q_l.shape[-1]
    x = torch.from_numpy(rng.standard_normal(lead + (m, kl)).astype(
        np.float32)).to(cuda)
    w_l = Q.QuantWeight(q=q_l, scale=s_l)
    if body == "unpack_apply":
        for mode, v in (("row", vr.float()), ("col", vc.float())):
            got = K.unpack_apply(p_l, v, w_l, mode=mode,
                                 out_dtype=torch.float32)
            want = R.unpack_apply_ref(p_l, v, q_l, mode,
                                      dtype=torch.float32, w_scale=s_l)
            assert torch.equal(got, want), mode
        return
    w_hat = ((vr.float()[..., :, None] + vc.float()[..., None, :])
             * D.unpack_signs(p_l, kl) + Q.dequantize(w_l))
    if body == "bitlinear_axes":
        got = BL.bitlinear_axes_p(x, p_l, vr, vc, q_l, w_scale=s_l)
        want = R.bitlinear_axes_ref(x, p_l, vr, vc, q_l, w_scale=s_l)
        scale = x.abs() @ w_hat.abs().T
    elif body == "bitlinear_axes_banked":
        bank = [torch.stack([torch.zeros_like(t), t, t])
                for t in (p_l, vr, vc)]
        bank[1][2].zero_()                      # slot 2: col-scaled only
        vidx = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=cuda)
        got = BL.bitlinear_axes_banked_p(x, vidx, *bank, q_l, w_scale=s_l)
        assert _banked_within_tolerance(got, x, vidx, *bank,
                                        Q.dequantize(w_l))
        return
    else:
        got = BL.bitlinear_axes_stacked_p(x, p_l, vr, vc, q_l, w_scale=s_l)
        want = R.bitlinear_axes_stacked_ref(x, p_l, vr, vc, q_l,
                                            w_scale=s_l)
        scale = torch.bmm(x.abs(), w_hat.abs().transpose(1, 2))
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_q8_rank_block_that_is_a_view_raises(cuda):
    """A rank's K-tile taken as a view (strided, not cut by
    ``sharding.block``) or without its scale raises in the wrapper; it is
    never copied into shape."""
    rng = np.random.default_rng(44)
    wb, packed, delta = _delta_case(rng, (), 64, 256, cuda)
    qw = Q.quantize_weight(wb)
    view = qw.q[:, 128:]
    assert not view.is_contiguous()
    x = torch.ones((4, 128), device=cuda)
    vr = torch.zeros(64, dtype=torch.float16, device=cuda)
    vc = torch.zeros(128, dtype=torch.float16, device=cuda)
    p_l = packed[:, 16:].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        BL.bitlinear_axes_p(x, p_l, vr, vc, view, w_scale=qw.scale)
    with pytest.raises(ValueError):
        BL.bitlinear_axes_p(x, p_l, vr, vc, view.contiguous())


def test_mesh_int8_on_card_quantizes_globally_and_matches_cpu(cuda,
                                                              tmp_path):
    """An int8 base on a (1, 2) mesh on the card: each rank quantizes its
    blocks there (the row absmax all-reduced over a sharded in dim), and
    every block is the CPU's single-device ``quantize_base`` block, bit for
    bit; every rank serves the CPU plain path's int8 tokens."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as LM
    import _mesh_ranks as MR
    build.library()
    path = _mesh_data(tmp_path)
    data = MR.load(path)
    runs = {"deepseek-7b": ("continuous", "group-dense"),
            "deepseek-moe-16b": ("group-fused",)}
    got = LM.spawn(MR.run, (1, 2), device="cuda", timeout_s=900,
                   args=(path, {"int8": runs}))
    for arch, scheds in runs.items():
        params = bridge.params_from_numpy(data[arch]["flat"], "cpu")
        whole, _, stats = Q.quantize_base(params)
        from repro_torch.core.calibration import flatten_params
        flat = flatten_params(whole)
        want = MR.mesh_tokens(None, arch, data[arch], kds=("shard_map",),
                              scheds=scheds, base_dtype="int8")
        for g in got:
            mine = g[("int8 blocks", arch)]
            assert mine["stats"] == stats
            mesh = S.Mesh(("data", "model"), (1, 2), coords=g["coords"])
            for p, (spec, q, scale) in mine["blocks"].items():
                assert np.array_equal(q, S.block(flat[p].q, spec,
                                                 mesh).numpy()), p
                assert np.array_equal(
                    scale.view(np.uint16),
                    S.block(flat[p].scale, spec[:-1], mesh).numpy().view(
                        np.uint16)), p
            for (kd, sched), toks in g[("int8 tokens", arch)].items():
                assert toks == want[("shard_map", sched)], (arch, kd, sched)
