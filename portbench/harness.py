"""One run of one cell: set-up, the measured window, the traced stretch, and
the record the metric readers and the correctness check read.

Set-up is everything from the process's start to the window's opening: the
import of the port, the load of its kernel library (built into the
checkout's ``build/kernels/`` on a checkout's first run), then the cell's
traffic module, which builds each candidate's problem and calls the
program's ``fit``; ``fit`` prepares the state, warms up and captures its
step, and runs its first chunk. The window opens when every candidate has
finished its first chunk (``fits.Window``).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Optional

from . import fits, trace as T

PORT = "mfvi_dip_mia_tpu_torch"


@dataclasses.dataclass
class Run:
    """What a run saw; the metric readers (portbench/metrics/) read it."""
    cell: object                      # spec.Cell
    seed: int
    seconds: float
    t_start: float                    # perf_counter at the process's start
    window: fits.Window
    candidates: list
    device: str
    setup: dict = dataclasses.field(default_factory=dict)
    trace: Optional[T.Trace] = None
    stretch: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    def rates(self) -> list:
        """Each candidate's it/s over the window (None: no whole chunk)."""
        w = self.window
        return [c.rate(w.w0, w.w1) if w.w0 is not None else None
                for c in self.candidates]


class Stretch:
    """Starts the profiler at candidate 0's first chunk end more than
    ``after`` seconds after the window opens and stops it ``chunks`` chunk
    ends later; reads the kernel launch counters at both ends. The window
    stays open until it is done: the profiler's first start (seconds of
    CUPTI's set-up) and its stop (seconds of flushing) fall inside a traced
    run's window, whose rates are therefore not reported. The chunks before
    the start and after the stop are those the span readers take
    (program.py)."""

    def __init__(self, run: Run, chunks: int, kernels, after: float = 0.0):
        self.run, self.chunks, self.kernels = run, int(chunks), kernels
        self.after = float(after)
        self.prof = T.Profiler()
        self.seen = 0
        self.done = False

    @property
    def running(self) -> bool:
        return self.seen > 0 and not self.done

    def on_chunk(self, cand: fits.Candidate, t: float) -> None:
        w = self.run.window
        if cand.index != 0 or self.done or w.w0 is None \
                or t <= w.w0 + (self.after if self.seen == 0 else 0.0):
            return
        if self.seen == 0:
            self.run.stretch.update(counts0=self.kernels.counts(),
                                    iters0=cand.chunks[-1][1])
            self.prof.start()
        elif self.seen == self.chunks:
            self.prof.stop()
            self.run.stretch.update(counts1=self.kernels.counts(),
                                    iters1=cand.chunks[-1][1],
                                    start_s=self.prof.start_s,
                                    stop_s=self.prof.stop_s)
            self.done = True
        self.seen += 1


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def import_port(device: str) -> tuple:
    """Import the port and load its kernel library on the card: (the
    package's modules, set-up seconds by part)."""
    import importlib
    t = time.perf_counter()
    port = {name: importlib.import_module(f"{PORT}.{name}") for name in
            ("tasks.trainer", "tasks.problems", "tasks.runners",
             "ops.kernels", "ops.kernels.build")}
    setup = {"import_s": time.perf_counter() - t}
    if device != "cpu":
        build = port["ops.kernels.build"]
        setup["library_first_build"] = not os.path.isdir(build.BUILD_ROOT) \
            or not os.listdir(build.BUILD_ROOT)
        t = time.perf_counter()
        build.library()
        setup["library_s"] = time.perf_counter() - t
    return port, setup


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", port=None, setup=None) -> Run:
    """Set up, run the window (and the traced stretch), and return the
    record. ``port``: the modules ``import_port`` gave, when the caller
    imported them already."""
    if port is None:
        port, setup = import_port(device)
    run = Run(cell, seed, seconds, t_start, None, [], device,
              setup=dict(setup or {}))
    stretch = None
    if trace:
        stretch = Stretch(run, cell.workload.get("trace_chunks", 3),
                          port["ops.kernels"],
                          cell.workload.get("trace_after_s", 0.0))
    traffic = cell.traffic()
    run.candidates = [fits.Candidate(i, temp, sigma) for i, (temp, sigma)
                      in enumerate(traffic.candidates(cell))]
    run.window = fits.Window(len(run.candidates), seconds,
                             stretch.on_chunk if stretch else None,
                             (lambda: not stretch.done) if stretch else None)
    try:
        with fits.probe(port["tasks.trainer"]):
            traffic.run(run, port)
    finally:
        if stretch is not None and stretch.running:
            stretch.prof.stop()
    if stretch is not None and stretch.done:
        run.trace = stretch.prof.reduce()
    return run
