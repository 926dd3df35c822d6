"""Device resolution for the port's entry points: they run on the card unless
the caller asks for the CPU, and never fall back to it quietly."""

from __future__ import annotations

import functools
import threading

import torch

_FILL_LOCK = threading.RLock()   # a fill may ask for another table


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
    and leave them as they are, and a check can show that it did.

    Fits on several threads (parallel/fanout.py) may ask for one entry at
    once: its first fill runs once, under one lock for every table (not
    the compile lock: PyTorch's autograd thread fills the backward's tables
    while the capturing thread holds that), and an entry is published only
    after the filling thread's stream has finished writing it, so that a
    fit on another stream reads it whole. Reads of a filled entry take no
    lock."""
    entries = {}

    @functools.wraps(fn)
    def cached(*args):
        if args not in entries:
            with _FILL_LOCK:
                if args not in entries:
                    value = fn(*args)
                    _written(value)
                    entries[args] = value
        return entries[args]

    cached.entries = entries
    cached.cache_clear = entries.clear
    return cached


def _written(value) -> None:
    """Wait until the current streams have written every CUDA tensor of
    ``value`` (a tensor, or tuples and lists of them); a capture in
    progress waits for nothing (it runs nothing)."""
    if isinstance(value, (tuple, list)):
        for v in value:
            _written(v)
    elif (isinstance(value, torch.Tensor) and value.is_cuda
          and not torch.cuda.is_current_stream_capturing()):
        torch.cuda.current_stream(value.device).synchronize()
