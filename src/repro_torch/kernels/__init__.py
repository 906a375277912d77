"""Hopper kernels of the port (CUDA C++ under ``repro_torch/csrc``), their
plain PyTorch versions and the public wrappers in ``ops``.

Kernels are built and loaded on first use (``kernels/build.py``), never at
import time."""
