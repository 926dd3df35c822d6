"""Tracing, timing and metric logs (counterpart of
mfvi_dip_mia_tpu/utils/profiling.py):

  * ``trace(logdir)``      — torch.profiler around a block (host and, on the
                             card, device activity), written into ``logdir``
                             as a Chrome trace (Perfetto / chrome://tracing)
  * ``PhaseTimer``         — wall time per named phase; ``sync=True`` waits
                             for the card at the phase's end, so the phase
                             holds the device work it launched
  * ``ThroughputMeter``    — units (iterations, MC samples) per second
  * ``JsonlLogger``        — append-only JSONL metric stream
  * ``debug_nans(enable)`` — torch.autograd's anomaly detection (a NaN in a
                             backward raises, naming the forward op)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


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


class ThroughputMeter:
    def __init__(self):
        self._t0: Optional[float] = None
        self._units = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        self._units = 0.0

    def add(self, units: float):
        self._units += units

    @property
    def per_sec(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._units / dt if dt > 0 else 0.0


class JsonlLogger:
    """Append-only JSONL metrics stream (one object per event)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def log(self, **fields):
        fields.setdefault("t", time.time())
        self._fh.write(json.dumps(fields) + "\n")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
