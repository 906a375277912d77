"""PyTorch/CUDA port of the per-axis weight-delta serving system.

Mirrors the JAX package ``repro`` module by module (same parameter tree,
same flat dot-paths, same overlay layout) and replaces each Pallas TPU
kernel on the ported path with a CUDA kernel written for Hopper
(``repro_torch/csrc``).  This package imports torch, numpy and the standard
library only — never ``jax`` and never ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
a host without a card they raise instead of carrying on on the CPU.
"""
