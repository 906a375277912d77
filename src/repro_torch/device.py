"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  A CUDA request on a host without a card raises —
    the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (timing around eager CUDA calls)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synchronize_stream(device: torch.device) -> None:
    """Wait for the current stream's queued work only: a side stream's
    copies (async admission's staging) go on meanwhile."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
