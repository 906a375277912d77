"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step counter, computed on the host in fp32 tensors as the JAX package
computes them (Python constants rounded to fp32 where JAX's weakly typed
scalars are), so both packages give the same learning rate bit for bit.

XLA's CPU backend evaluates ``cos`` with the C library's ``cosf``;
``torch.cos`` rounds differently (and differently again on CUDA), so the
cosine goes through ``cosf`` too.  The result is a 0-d (or step-shaped)
fp32 CPU tensor, which the optimizer update multiplies into device
tensors as a scalar.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.lru_cache(maxsize=1)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise fp32 cos of a CPU fp32 tensor through ``cosf``."""
    fn = _cosf()
    vals = [fn(v) for v in x.reshape(-1).tolist()]
    return torch.tensor(vals, dtype=torch.float32).reshape(x.shape)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32, device="cpu")


def linear_warmup(step, warmup: int, peak: float) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float32)
    return peak * torch.minimum(one, (_step(step) + 1) / max(warmup, 1))


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak``, then a cosine down to ``floor · peak`` at
    ``total``; ``step`` an int or an int tensor, the result fp32."""
    step = _step(step)
    warm = linear_warmup(step, warmup, peak)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + _cos32(math.pi * frac))
    return torch.where(step < warmup, warm, peak * cos)
