"""CUDA graph capture for the port's replayed work (a fit's step, the steps
of a block of candidates, an MC sample): one capture stream per card, and a
capture that registers the random streams and counts what a replay
launches."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops import kernels

_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card for every graph's warm-up and capture, as
    ``torch.cuda.graph`` keeps one: PyTorch keeps a cuBLAS workspace for
    each stream cuBLAS has run on until the process ends, so a new stream
    per capture would leave more device memory allocated after every fit."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def capture(fn: Callable, generators: Sequence[torch.Generator],
            stream: torch.cuda.Stream) -> tuple:
    """``fn()`` captured on ``stream`` as a CUDA graph: (graph, the kernel
    launches one replay makes, what ``fn`` returned, in the graph's
    memory). Every generator of ``generators`` is registered with the
    graph, so each replay draws the next numbers of each stream, as an
    eager call would. The capture's launch counts are taken back off the
    counters; the caller adds them once per replay
    (``kernels.add_counts``)."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    before = kernels.counts()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, kernels.take_counts_since(before), out
