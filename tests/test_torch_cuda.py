"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips on a CPU host; the
decision is taken inside the ``cuda`` fixture, never at import time.

Run on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``unpack_apply`` does the plain version's arithmetic exactly
(one fp32 add per element), so it must be bit-identical.
``bitlinear_axes`` builds the same fp32 Ŵ and sums the products in another
order; the bound is 1e-5 relative to Σ|x||Ŵ| per output (fp32 summation of
K ≤ 1032 terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import delta as D  # noqa: E402
from repro_torch.kernels import bitlinear as BL  # noqa: E402
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
