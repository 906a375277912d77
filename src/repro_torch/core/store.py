"""Artifact store (port of ``repro.core.store``) — only the base-checkpoint
fingerprint so far, which the variant registry keeps.  It equals the JAX
package's fingerprint of the same weights, so artifacts stay verifiable
across the two packages once the store itself is ported.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.calibration import flatten_params


def base_fingerprint(base_params) -> str:
    """Cheap fingerprint of the base checkpoint: per leaf (sorted by
    dot-path) the path, the shape rendered as a tuple, and the bytes of the
    first 64 elements."""
    h = hashlib.sha256()
    for path, leaf in sorted(flatten_params(base_params).items()):
        h.update(path.encode())
        h.update(str(tuple(leaf.shape)).encode())
        head = leaf.detach().reshape(-1)[:64].cpu()
        if head.dtype in (torch.bfloat16, torch.float16):
            head = head.view(torch.int16)
        h.update(head.numpy().tobytes())
    return h.hexdigest()[:16]
