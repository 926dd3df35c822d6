"""Tracing, timing and debugging (counterpart of
mfvi_dip_mia_tpu/utils/profiling.py):

  * ``TRACER``             — the port's spans (``Tracer``): a name, a start
                             and an end on ``time.time_ns()`` (the clock of
                             torch.profiler's events), the parent span, the
                             thread and attributes, kept in memory in a
                             bounded ring. On by default; ``TRACER.enabled =
                             False`` keeps no span and makes no ``Marks``
  * ``Marks``              — times at fixed boundaries of a repeated step,
                             and at named points inside it: timing events
                             on the card (inside a CUDA graph, event-record
                             nodes every replay records again), host times
                             elsewhere
  * ``trace(logdir)``      — torch.profiler around a block (host and, on the
                             card, device activity), written into ``logdir``
                             as a Chrome trace (Perfetto / chrome://tracing);
                             the spans opened in it show in it
  * ``PhaseTimer``         — wall time per named phase; ``sync=True`` waits
                             for the card at the phase's end, so the phase
                             holds the device work it launched
  * ``debug_nans(enable)`` — torch.autograd's anomaly detection (a NaN in a
                             backward raises, naming the forward op)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import torch

TRACE_FILE = "trace.json"
# spans kept: a 100,000-iteration fit in chunks of 100 ends ~1,010 spans
SPAN_RING = 1 << 16
_INNERMOST = object()     # Tracer.span's default parent


@dataclasses.dataclass(eq=False)
class Span:
    """One timed piece of work. ``start_ns`` / ``end_ns``: ``time.time_ns()``
    (``end_ns`` None while open); ``parent``: the enclosing Span or None;
    ``thread``: ``threading.get_ident()`` of the thread that opened it."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional["Span"]
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Tracer:
    """Spans of the port's work, each thread with its own stack of open
    spans (the fanout runs fits on threads). A span is kept when it ends,
    in a ring of the last ``capacity``. While torch.profiler runs on the
    opening thread, a span also shows in the profiler's timeline as a host
    range of its name (a ``FUNCTION``-scope record, which annotates no
    device activity)."""

    def __init__(self, capacity: int = SPAN_RING):
        self.enabled = True
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """The innermost span open on the calling thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def start(self, name: str, parent=_INNERMOST, **attrs) -> Span:
        """Open a span outside the thread's stack (spans of several fits
        interleaved in one loop); ``finish`` ends it."""
        if parent is _INNERMOST:
            parent = self.current()
        return Span(name, time.time_ns(), None, parent,
                    threading.get_ident(), attrs)

    def finish(self, span: Span) -> Span:
        span.end_ns = time.time_ns()
        if self.enabled:
            with self._lock:
                self._ring.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent=_INNERMOST, **attrs):
        """Time the block as span ``name``, a child of ``parent`` (default:
        the innermost span open on this thread), and yield it: the block
        may add attributes. The span is timed and yielded even when the
        tracer is off, which then keeps it nowhere."""
        sp = self.start(name, parent, **attrs)
        record = None
        if self.enabled and torch._C._autograd._profiler_enabled():
            record = torch._C._profiler._RecordFunctionFast(name)
            record.__enter__()
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            if record is not None:
                record.__exit__(None, None, None)
            self.finish(sp)

    def spans(self, name: Optional[str] = None) -> list:
        """The kept spans (all, or those named ``name``), in the order they
        ended."""
        with self._lock:
            kept = list(self._ring)
        return kept if name is None else [s for s in kept if s.name == name]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


TRACER = Tracer()


class Marks:
    """Times at the ``len(regions) + 1`` boundaries of a repeated step,
    read as each region's milliseconds, and at the named ``points`` inside
    it, read against the boundaries by ``between``. On a card each is a
    timing event recorded on the device's current stream, created
    ``external``: inside a CUDA graph capture its recording becomes an
    event-record node that every replay records again, so ``read`` gives
    the last replay's (or the last eager step's) device time. Elsewhere a
    boundary takes the host's time (``clock`` 'host')."""

    def __init__(self, regions: Sequence[str], device: torch.device,
                 points: Sequence[str] = ()):
        self.regions = tuple(regions)
        self.points = tuple(points)
        self.device = device
        self.clock = "device" if device.type == "cuda" else "host"
        n = len(self.regions) + 1 + len(self.points)
        if self.clock == "device":
            self._events = [torch.cuda.Event(enable_timing=True, external=True)
                            for _ in range(n)]
        else:
            self._ns = [0] * n
        self._seen = set()     # the slots recorded at least once

    def _slot(self, k) -> int:
        """A boundary's number, or a point's name, as its slot."""
        if isinstance(k, int):
            return k
        return len(self.regions) + 1 + self.points.index(k)

    def _record(self, i: int) -> None:
        if self.clock == "device":
            self._events[i].record(torch.cuda.current_stream(self.device))
        else:
            self._ns[i] = time.perf_counter_ns()
        self._seen.add(i)

    def mark(self, k: int) -> None:
        """Boundary ``k``: before region k, after region k - 1."""
        self._record(k)

    def point(self, name: str) -> None:
        """The named point ``name``, on whichever thread reaches it (a
        tensor hook runs on autograd's thread, on the forward's stream)."""
        self._record(self._slot(name))

    def _ms(self, a: int, b: int) -> float:
        if self.clock == "device":
            return self._events[a].elapsed_time(self._events[b])
        return (self._ns[b] - self._ns[a]) / 1e6

    def read(self) -> dict:
        """{region: ms} of the last step that passed every boundary; on a
        card, once that step's work is done (the caller has waited for
        it)."""
        return {r: self._ms(k, k + 1) for k, r in enumerate(self.regions)}

    def between(self, a, b) -> Optional[float]:
        """The ms from ``a`` to ``b`` (each a boundary's number or a point's
        name) in the last step that recorded both, as ``read``; None where
        either was never recorded."""
        a, b = self._slot(a), self._slot(b)
        if a not in self._seen or b not in self._seen:
            return None
        return self._ms(a, b)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the Chrome trace goes to ``logdir/trace.json``.
    The profiler is yielded (its ``key_averages()`` summarize the block)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                # the block's own stream: a device-wide wait would also wait
                # for, and may break, other threads' captures
                torch.cuda.current_stream().synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class PhaseTimer:
    """Accumulates wall time per named phase (e.g. the first dispatch, which
    builds and captures, against the later ones). ``phase(name,
    sync=True)`` first waits for the calling thread's current stream."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name]
                                       / max(self.counts[name], 1), 6)}
                for name in self.totals}
