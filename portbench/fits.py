"""The harness's view of the fits a cell runs: the measured window, one
record per candidate fit, and the probe that reads each fit's state.

The window. Each fit reports once per chunk through ``fit``'s ``log_fn``,
on its own thread, after the host has read the chunk's metric rows (so the
chunk's work is done). The window opens when every candidate of the cell has
finished its first chunk (warm-up, capture and one chunk are set-up) and
closes ``seconds`` later; each candidate's first ``log_fn`` after the close
raises ``WindowClosed``, which ends its fit at that chunk boundary. A
candidate's rate is its whole chunks that ended inside the window over the
seconds they span, from its first chunk end in the window to its last.

The probe wraps two functions of the program's trainer for the run:
``prepare_fit``, to hold the fit's state and take its initial parameters,
and ``capture_step``, to time the warm-up and capture and to wrap each graph
so that the state is read after the first three replays (on the CPU, where
the trainer steps eagerly, the prepared step is wrapped instead) and the
host's seconds inside each replay are summed. The reads are set-up: they
end before the first chunk does.

A traffic module hands the probe the candidates whose fits a thread runs,
in the order the program prepares them (``assigned``): one, or several
that one call prepares one after another (``fit_interleaved``). Each
``prepare_fit`` on the thread takes the next of them, and each
``capture_step`` goes to the candidate whose prepared state it captures;
calls beyond them, and on other threads, pass through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

PROBE_STEPS = 3


class WindowClosed(Exception):
    """Raised from ``log_fn`` to end a fit at the first chunk boundary after
    the window closed."""


@dataclasses.dataclass
class Candidate:
    """One fit of the cell and what the harness saw of it."""
    index: int
    temp: float
    sigma: float
    t_call: float = 0.0                  # the call into fit
    t_prepared: Optional[float] = None   # prepare_fit returned
    t_capture: Optional[tuple] = None    # capture_step's (start, end)
    launches: Optional[tuple] = None     # kernel launches of one replay
    chunks: list = dataclasses.field(default_factory=list)  # (t, iters,
                                         # host seconds inside replays)
    replay_s: float = 0.0                # host seconds inside graph replays
    nonfinite_chunks: int = 0
    error: Optional[str] = None
    # the probe's reads, on the fit's device
    prep: object = None
    flat0: Optional[torch.Tensor] = None
    m1: Optional[torch.Tensor] = None
    flat3: Optional[torch.Tensor] = None
    rows3: Optional[torch.Tensor] = None
    steps_seen: int = 0

    @property
    def first_chunk_end(self) -> Optional[float]:
        return self.chunks[0][0] if self.chunks else None

    def chunks_in(self, w0: float, w1: float) -> list:
        """(seconds, host seconds inside replays) of each whole chunk that
        ended in [w0, w1] after the first such chunk end."""
        inside = [(t, r) for t, _, r in self.chunks if w0 <= t <= w1]
        return [(b[0] - a[0], b[1] - a[1])
                for a, b in zip(inside, inside[1:])]

    def span(self, w0: float, w1: float) -> Optional[tuple]:
        """(iterations, seconds) of the whole chunks that ended in
        [w0, w1], from the first such chunk end to the last."""
        inside = [(t, n) for t, n, _ in self.chunks if w0 <= t <= w1]
        if len(inside) < 2:
            return None
        (ta, na), (tb, nb) = inside[0], inside[-1]
        return nb - na, tb - ta

    def rate(self, w0: float, w1: float) -> Optional[float]:
        s = self.span(w0, w1)
        return s[0] / s[1] if s and s[1] > 0 else None

    def after_step(self, state) -> None:
        """Read the state after each of the first ``PROBE_STEPS`` steps:
        Adam's first moment after step 1, the parameters and the metric rows
        after the last."""
        self.steps_seen += 1
        n = self.steps_seen
        if n > PROBE_STEPS:
            return
        if state.flat.is_cuda:
            torch.cuda.current_stream(state.flat.device).synchronize()
        if n == 1:
            self.m1 = state.m.detach().clone()
        if n == PROBE_STEPS:
            self.flat3 = state.flat.detach().clone()
            self.rows3 = state.rows[:PROBE_STEPS].detach().clone()


class Window:
    """The measured window shared by the cell's candidates."""

    def __init__(self, n_candidates: int, seconds: float,
                 on_chunk: Optional[Callable] = None,
                 hold: Optional[Callable] = None):
        self.n = n_candidates
        self.seconds = float(seconds)
        self.lock = threading.Lock()
        self.ready = set()
        self.w0: Optional[float] = None
        self.on_chunk = on_chunk          # (candidate, t) -> None, traced runs
        self.hold = hold                  # () -> True keeps a traced window
                                          # open until its stretch is done

    @property
    def w1(self) -> Optional[float]:
        return None if self.w0 is None else self.w0 + self.seconds

    def log_fn(self, cand: Candidate) -> Callable:
        """``fit``'s log_fn for ``cand``."""
        def log_fn(i, row):
            t = time.perf_counter()
            cand.chunks.append((t, int(i) + 1, cand.replay_s))
            if not np.all(np.isfinite(np.asarray(row, np.float64))):
                cand.nonfinite_chunks += 1
            with self.lock:
                if cand.index not in self.ready:
                    self.ready.add(cand.index)
                    if len(self.ready) == self.n:
                        self.w0 = t
                closed = self.w0 is not None and t > self.w1
            if self.on_chunk is not None:
                self.on_chunk(cand, t)
            if closed and not (self.hold is not None and self.hold()):
                raise WindowClosed()
        return log_fn


class _Local(threading.local):
    pending: tuple = ()       # candidates still to prepare, in call order
    prepared: tuple = ()      # candidates prepared on this thread


CURRENT = _Local()


@contextlib.contextmanager
def assigned(cands):
    """For the block, the fits this thread prepares are those of ``cands``,
    in this order."""
    CURRENT.pending, CURRENT.prepared = tuple(cands), ()
    try:
        yield
    finally:
        CURRENT.pending, CURRENT.prepared = (), ()


class _ProbedGraph:
    """A captured graph whose replays report to the candidate's probe."""

    def __init__(self, graph, cand: Candidate, state):
        self.graph, self.cand, self.state = graph, cand, state

    def replay(self):
        t = time.perf_counter()
        self.graph.replay()
        self.cand.replay_s += time.perf_counter() - t
        if self.cand.steps_seen < PROBE_STEPS:
            self.cand.after_step(self.state)


@contextlib.contextmanager
def probe(trainer):
    """Wrap ``trainer.prepare_fit`` and ``trainer.capture_step`` (the
    program's ``tasks/trainer.py`` module) for the fits of the candidates
    ``assigned`` to the calling thread; other calls pass through."""
    prepare_fit, capture_step = trainer.prepare_fit, trainer.capture_step

    def prepare_probed(*args, **kwargs):
        prep = prepare_fit(*args, **kwargs)
        if not CURRENT.pending:
            return prep
        cand = CURRENT.pending[0]
        CURRENT.pending = CURRENT.pending[1:]
        CURRENT.prepared += (cand,)
        cand.t_prepared = time.perf_counter()
        cand.prep = prep
        cand.flat0 = prep.state.flat.detach().clone()
        step, state = prep.step, prep.state

        def step_probed(s, with_metrics):
            step(s, with_metrics)
            if s is state and not (s.flat.is_cuda and
                                   torch.cuda.is_current_stream_capturing()):
                cand.after_step(s)

        return prep._replace(step=step_probed)

    def capture_probed(step, state, gen):
        cand = next((c for c in CURRENT.prepared if c.prep.state is state),
                    None)
        if cand is None:
            return capture_step(step, state, gen)
        t0 = time.perf_counter()
        graphs = capture_step(step, state, gen)
        cand.t_capture = (t0, time.perf_counter())
        cand.launches = graphs[True][1]
        return {k: (_ProbedGraph(g, cand, state), n)
                for k, (g, n) in graphs.items()}

    trainer.prepare_fit, trainer.capture_step = prepare_probed, capture_probed
    try:
        yield
    finally:
        trainer.prepare_fit, trainer.capture_step = prepare_fit, capture_step
