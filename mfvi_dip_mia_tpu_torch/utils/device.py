"""Device resolution for the port's entry points: they run on the card unless
the caller asks for the CPU, and never fall back to it quietly."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises.

    Besides torch devices and their names, the reference's spellings are
    taken: an integer ordinal or a name with one ("cuda:1", "tpu:3") means
    that CUDA device modulo the number of cards, so ``configs/*.json`` run
    unchanged (runners.py:28-41)."""
    if isinstance(device, int) or (
            isinstance(device, str) and not device.startswith(("cpu", "cuda"))):
        idx = device if isinstance(device, int) else (
            int(device.rsplit(":", 1)[1]) if ":" in device else 0)
        _require_cuda()
        return torch.device("cuda", idx % torch.cuda.device_count())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _require_cuda()
        if dev.index is not None:
            dev = torch.device("cuda", dev.index % torch.cuda.device_count())
    return dev


def local_cards() -> list:
    """Every card this process sees, as ``cuda:<i>`` devices; raises without
    one (the counterpart of ``jax.local_devices()`` as the JAX package's
    fanout and mesh take it)."""
    _require_cuda()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card; pass "
            "device='cpu' explicitly to run its plain CPU path")


def device_cache(fn):
    """``functools.cache`` for a function that builds device tensors
    (positional arguments only), with its entries readable as ``fn.entries``
    (argument tuple -> result): a CUDA graph's capture must find them built
    and leave them as they are, and a check can show that it did."""
    entries = {}

    @functools.wraps(fn)
    def cached(*args):
        if args not in entries:
            entries[args] = fn(*args)
        return entries[args]

    cached.entries = entries
    cached.cache_clear = entries.clear
    return cached
