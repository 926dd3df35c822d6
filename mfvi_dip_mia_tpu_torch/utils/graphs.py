"""CUDA graph capture for the port's replayed work (a fit's step, the steps
of a block of candidates, an MC sample), and the streams fits run on.

Fits run concurrently on several threads (parallel/fanout.py), so each
thread works on a stream of its own: ``own_stream`` runs a block on a
stream leased from a small pool per card, and ``capture_stream`` is the
stream a thread warms up and captures on (its leased stream inside
``own_stream``, else one it keeps for its lifetime). The pool hands a
stream to one thread at a time and creates one only when every stream of
the card is leased: PyTorch keeps a cuBLAS workspace for each stream cuBLAS
has run on until the process ends, so a new stream per fit would leave
more device memory allocated after every fit. Kernels that keep a scratch
buffer across launches key it by the stream they launch on
(ops/kernels/cf_conv.py::_tickets), so one thread's launches and replays
never share one with another's."""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Sequence

import torch

from ..ops import kernels

_POOL_LOCK = threading.RLock()   # reentrant: a finalizer may release
_FREE: dict = {}              # device -> streams no thread holds
_HELD = threading.local()     # .streams: {device: the thread's stream}


def _held() -> dict:
    streams = getattr(_HELD, "streams", None)
    if streams is None:
        streams = _HELD.streams = {}
    return streams


def _card(device: torch.device) -> torch.device:
    """``device`` with its ordinal ("cuda" is the current card), so that one
    card has one key."""
    if device.index is None:
        return torch.device(device.type, torch.cuda.current_device())
    return device


def _lease(device: torch.device) -> torch.cuda.Stream:
    with _POOL_LOCK:
        free = _FREE.setdefault(device, [])
        if free:
            return free.pop()
    return torch.cuda.Stream(device)


def _release(device: torch.device, stream: torch.cuda.Stream) -> None:
    with _POOL_LOCK:
        _FREE[device].append(stream)


@contextlib.contextmanager
def own_stream(device: torch.device):
    """Run the block on ``device`` (made the current device) with the
    calling thread's own stream as the current stream: the one it holds
    (``capture_stream``), or one leased from the card's pool for the block
    and given back after it. The stream first waits for the caller's
    stream, and the caller's stream waits for it when the block ends. Work
    queued in the block runs in order with the thread's captures and
    replays and beside other threads' work. Inside another ``own_stream``
    of the device it changes nothing; on a CPU device, nothing at all."""
    if device.type != "cuda":
        yield
        return
    device, held = _card(device), _held()
    with torch.cuda.device(device):
        caller = torch.cuda.current_stream(device)
        stream = held.get(device)
        if stream is not None and stream == caller:
            yield
            return
        leased = stream is None
        if leased:
            stream = held[device] = _lease(device)
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)
            if leased:
                del held[device]
                _release(device, stream)


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's stream for warm-ups and captures on ``device``:
    the stream of its ``own_stream`` when it runs in one (the graphs then
    replay on the stream they were captured on), else a stream leased for
    the thread's lifetime (given back when the thread object is
    collected)."""
    device, held = _card(device), _held()
    if device not in held:
        held[device] = _lease(device)
        weakref.finalize(threading.current_thread(), _release, device,
                         held[device])
    return held[device]


def capture(fn: Callable, generators: Sequence[torch.Generator],
            stream: torch.cuda.Stream) -> tuple:
    """``fn()`` captured on ``stream`` as a CUDA graph: (graph, the kernel
    launches one replay makes, what ``fn`` returned, in the graph's
    memory). Every generator of ``generators`` is registered with the
    graph, so each replay draws the next numbers of each stream, as an
    eager call would. The caller holds the compile lock
    (utils/compile_guard.py::held), and only the calling thread's calls can
    invalidate the capture (``capture_error_mode="thread_local"``): other
    threads' replays, eager steps and allocations go on meanwhile. The
    launches counted on ``stream`` during the capture (the backward's too,
    which PyTorch's autograd thread launches onto it) are taken back off
    the counters; the caller adds them once per replay
    (``kernels.add_counts``)."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    before = kernels.stream_counts(stream.cuda_stream)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return (graph, kernels.take_counts_since(before, stream.cuda_stream),
            out)
