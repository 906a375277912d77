"""Compressed linear module (port of ``repro.core.bitdelta``): the paper's
drop-in replacement layer.

A :class:`DeltaLinear` is one patched linear projection

    y = x @ (v ⊙ unpack(B) + W_b)ᵀ

in one of three apply modes:

* ``"dense"`` — reconstruct Ŵ, then one product (the deployed mode: the
  residual is added once, so inference equals the dense weights);
* ``"onfly"`` — the fused static-mode delta GEMM on every call
  (``kernels/ops.bitlinear``: the ``bitlinear_p`` CUDA kernel on the card,
  its plain version on the CPU);
* ``"ref"`` — the plain factored product of ``core/delta.delta_matmul``.

``w_base`` may be a ``core/quantize.QuantWeight`` for ``"onfly"``, as in
the JAX module.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import delta as D


@dataclasses.dataclass
class DeltaLinear:
    """State of one compressed projection."""
    packed: torch.Tensor         # (d_out, d_in//8) uint8
    v: torch.Tensor              # (d_out,) | (d_in,) | () fp16/fp32
    w_base: torch.Tensor         # (d_out, d_in)
    mode: str = "row"

    @property
    def shape(self) -> tuple:
        return tuple(self.w_base.shape)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_pair(cls, w_base: torch.Tensor, w_ft: torch.Tensor,
                  mode: str) -> "DeltaLinear":
        packed, v0 = D.compress(w_base, w_ft, mode)
        return cls(packed=packed, v=v0, w_base=w_base, mode=mode)

    # -- forward -----------------------------------------------------------
    def reconstruct(self, dtype=None) -> torch.Tensor:
        return D.reconstruct(self.packed, self.v, self.w_base, self.mode,
                             dtype=dtype)

    def __call__(self, x: torch.Tensor, apply_mode: str = "ref"
                 ) -> torch.Tensor:
        if apply_mode == "ref":
            *lead, k = x.shape
            y = D.delta_matmul(x.reshape(-1, k), self.packed, self.v,
                               self.w_base, self.mode)
            return y.reshape(*lead, -1)
        if apply_mode == "onfly":
            from repro_torch.kernels import ops as K
            return K.bitlinear(x, self.packed, self.v, self.w_base,
                               mode=self.mode)
        if apply_mode == "dense":
            return x @ self.reconstruct(dtype=x.dtype).T
        raise ValueError(apply_mode)

    # -- accounting --------------------------------------------------------
    def artifact_bytes(self) -> int:
        d_out, d_in = self.w_base.shape
        return D.artifact_bytes(d_out, d_in, self.mode)


def reconstruction_error(lin: DeltaLinear, w_ft: torch.Tensor
                         ) -> torch.Tensor:
    """||Ŵ - W_f||_F / ||W_f - W_b||_F — the weight-space residual."""
    w_hat = lin.reconstruct(dtype=torch.float32)
    num = torch.linalg.norm(w_hat - w_ft.to(torch.float32))
    den = torch.linalg.norm(w_ft.to(torch.float32)
                            - lin.w_base.to(torch.float32)) + 1e-12
    return num / den


def best_static_axis(w_base: torch.Tensor, w_ft: torch.Tensor) -> str:
    """The axis (row or col) whose init scale leaves the lower Frobenius
    residual — the calibration-free heuristic."""
    errs = {mode: float(reconstruction_error(
        DeltaLinear.from_pair(w_base, w_ft, mode), w_ft))
        for mode in ("row", "col")}
    return min(errs, key=errs.get)
