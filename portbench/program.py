"""The program's own spans, for the readers whose source is
``program_span``. The port's tracer (mfvi_dip_mia_tpu_torch/utils/
profiling.py::TRACER, on by default) keeps a ``fit`` span for each fit,
with its ``capture`` span and a ``chunk`` span per chunk
(tasks/trainer.py::fit); a chunk span carries the device time of its
replays and of its last replay's regions, from timing events the fit
records on its stream (no profiler).

``fits`` matches each candidate of the run to its fit span by (temp,
sigma). ``chunks`` takes the candidates' chunk spans whose last iteration
ends one of the whole chunks the window counts (the iterations of
``Candidate.chunks``, as ``Candidate.rate`` counts them), and leaves out
every chunk that overlaps the traced stretch's profiler, from its start to
its stop (``trace.Trace.t0`` less the start's seconds to ``t1`` plus the
stop's, on the clock both share, ``time.time_ns()``), since CUPTI
lengthens the kernels it traces. Each returns None on the CPU (a chunk's
times there are the host's) and with a program that keeps no spans.
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional


def _tracer(run):
    if run.device == "cpu":
        return None
    try:
        from mfvi_dip_mia_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "TRACER", None)


def fits(run) -> Optional[list]:
    """Each candidate's fit span, in the candidates' order, or None."""
    tracer = _tracer(run)
    if tracer is None:
        return None
    spans = tracer.spans("fit")
    found = []
    for c in run.candidates:
        mine = [s for s in spans
                if (s.attrs.get("temp"), s.attrs.get("sigma"))
                == (c.temp, c.sigma)]
        if not mine:
            return None
        found.append(mine[-1])
    return found


def captures(run) -> Optional[list]:
    """Each candidate's ``capture`` span, or None."""
    fs = fits(run)
    if fs is None:
        return None
    spans = _tracer(run).spans("capture")
    found = [[s for s in spans if s.parent is f] for f in fs]
    if not all(found):
        return None
    return [mine[-1] for mine in found]


def _stretch(run) -> Optional[tuple]:
    """(lo, hi) ns of the profiler's run, (None, None) where none ran, and
    None where it ran over an interval the run does not know."""
    tr, st = run.trace, run.stretch
    if tr is None:
        return None if "counts0" in st else (None, None)
    return (tr.t0 - int(st.get("start_s", 0.0) * 1e9),
            tr.t1 + int(st.get("stop_s", 0.0) * 1e9))


def chunks(run) -> Optional[list]:
    """The chunk spans of the window's whole chunks, timed on the device
    and outside the profiler's run, or None."""
    fs, w, stretch = fits(run), run.window, _stretch(run)
    if fs is None or w is None or w.w0 is None or stretch is None:
        return None
    lo, hi = stretch
    spans = _tracer(run).spans("chunk")
    found = []
    for c, f in zip(run.candidates, fs):
        ends = [n for t, n, _ in c.chunks if w.w0 <= t <= w.w1]
        counted = set(ends[1:])
        for s in spans:
            if (s.parent is not f or s.attrs.get("clock") != "device"
                    or s.attrs.get("last", -2) + 1 not in counted
                    or not s.attrs.get("replays")):
                continue
            if lo is not None and s.start_ns < hi and s.end_ns > lo:
                continue
            found.append(s)
    return found or None


def chunk_median(run, value: Callable) -> Optional[float]:
    """The median of ``value(span)`` over ``chunks(run)``, or None."""
    spans = chunks(run)
    if spans is None:
        return None
    return statistics.median(value(s) for s in spans)


def region_ms(run, region: str) -> Optional[float]:
    """The median over the window's chunks of their last replay's
    ``region`` (tasks/trainer.py::STEP_REGIONS), in ms, or None."""
    spans = chunks(run)
    if spans is None or any(region not in s.attrs.get("regions_ms", {})
                            for s in spans):
        return None
    return statistics.median(s.attrs["regions_ms"][region] for s in spans)
