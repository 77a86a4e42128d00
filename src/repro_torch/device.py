"""Where the port's tensors go: the card unless the caller asks otherwise.

Every entry point that makes tensors (forecasters, models, caches, the
decode engine) takes ``device=None``, which means the current CUDA device,
and raises where there is none; tests and CPU runs pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without an index is pinned to
    the current one, so equal placements compare equal."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "asks for the CPU (device='cpu')")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
