"""Device resolution for the port's entry points: they run on the card unless
the caller asks for the CPU, and never fall back to it quietly."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card; pass "
            "device='cpu' explicitly to run its plain CPU path")
    return dev
