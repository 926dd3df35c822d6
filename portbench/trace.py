"""The traced stretch of a ``--trace 1`` run: torch.profiler (CUPTI) over a
few chunks shortly after the window opens, reduced to what the per-layer
readers and the result line need.

Only the profiler's own records are read (``kineto_results.events()``, the
same timeline a Chrome trace shows): every device operation (kernels, copies,
fills) with its start, duration and the correlation id of the host call
that launched it, and the host's CUDA runtime calls. A CUDA graph replay is
one host call (``cudaGraphLaunch``) whose kernels all carry its correlation
id, so the kernels of one replay of a fit's step are one group; a group cut
by the stretch's edges counts as the share of a whole replay it holds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import time
from typing import Optional

DEVICE_OPS = 10          # entries of the breakdown's lists


@dataclasses.dataclass
class Op:
    name: str
    start: int            # ns, on the profiler's clock
    dur: int              # ns
    corr: int


@dataclasses.dataclass
class Trace:
    """The reduced traced stretch."""
    t0: int                       # ns, the stretch's ends on the profiler's
    t1: int                       # clock
    ops: list                     # device Ops in the stretch, by start
    host: list                    # host CUDA runtime calls (name, start,
                                  # dur) in the stretch, by start
    graph_launches: int           # cudaGraphLaunch calls in the stretch

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self) -> list:
        return [o for o in self.ops if not _is_copy(o.name)]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        stretch, as sorted disjoint (start, end) pairs."""
        merged = []
        for o in self.ops:
            a, b = max(o.start, self.t0), min(o.start + o.dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def _replay_sizes(self) -> list:
        """The kernel count of each host launch that launched more than one
        kernel (a graph replay)."""
        groups = collections.Counter(o.corr for o in self.kernels()
                                     if o.corr)
        return [n for n in groups.values() if n > 1]

    def kernels_per_replay(self) -> Optional[int]:
        sizes = self._replay_sizes()
        return statistics.mode(sizes) if sizes else None

    def replays(self) -> Optional[float]:
        """The step replays in the stretch, a replay cut by its edges counted
        by its share of kernels; None where the kernels carry no
        correlation that groups them."""
        full = self.kernels_per_replay()
        if full is None:
            return None
        return sum(min(n, full) for n in self._replay_sizes()) / full

    def replay_idle(self) -> Optional[tuple]:
        """(idle ns, span ns) summed over the whole replays in the stretch:
        a replay's span runs from its first kernel's start to its last
        kernel's end, and its idle is the part of the span in which none of
        its kernels runs. The gaps between replays are left out: under the
        profiler they are mostly the host's time in ``cudaGraphLaunch``,
        which untraced runs ahead of the card."""
        full = self.kernels_per_replay()
        if full is None:
            return None
        groups = collections.defaultdict(list)
        for o in self.kernels():
            if o.corr:
                groups[o.corr].append(o)
        idle = span = 0
        for ops in groups.values():
            if len(ops) != full:
                continue
            end = ops[0].start
            first = ops[0].start
            for o in ops:
                if o.start > end:
                    idle += o.start - end
                end = max(end, o.start + o.dur)
            span += end - first
        return (idle, span) if span else None

    def device_ops(self) -> list:
        """[name, seconds] of the device operations that took most time."""
        tot = collections.Counter()
        for o in self.ops:
            tot[o.name] += o.dur
        return [[n, d / 1e9] for n, d in tot.most_common(DEVICE_OPS)]

    def idle_gaps(self) -> list:
        """[what the host was doing, seconds]: the device's idle time in the
        stretch, by the host runtime call in flight at each gap's middle (the
        latest started), largest total first."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [h[1] for h in self.host]
        tot = collections.Counter()
        for a, b in gaps:
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid)
            name = "host outside any CUDA call"
            # the latest host call started before the middle still running
            for j in range(k - 1, max(k - 64, -1), -1):
                hn, hs, hd = self.host[j]
                if hs + hd >= mid:
                    name = hn
                    break
            tot[name] += b - a
        return [[n, d / 1e9] for n, d in tot.most_common(DEVICE_OPS)]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Profiler:
    """torch.profiler around the stretch, started and stopped from the fit's
    ``log_fn`` (at chunk ends, when the host has read the chunk)."""

    def __init__(self):
        import torch.profiler as tp
        self._tp = tp
        self.prof = None
        self.t0 = self.t1 = None
        self.start_s = self.stop_s = 0.0

    def _new(self):
        tp = self._tp
        return tp.profile(activities=[tp.ProfilerActivity.CPU,
                                      tp.ProfilerActivity.CUDA])

    def start(self) -> None:
        t = time.perf_counter()
        self.prof = self._new()
        self.prof.start()
        self.t0 = time.time_ns()
        self.start_s = time.perf_counter() - t

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def reduce(self) -> Trace:
        """The stretch as a ``Trace`` (call after ``stop``)."""
        from torch.autograd import DeviceType
        ops, host, launches = [], [], 0
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if start + dur > self.t0 and start < self.t1:
                    ops.append(Op(e.name(), start, dur, e.correlation_id()))
            else:
                name = e.name()
                if name.startswith("cuda") and self.t0 <= start <= self.t1:
                    host.append((name, start, dur))
                    if name.startswith("cudaGraphLaunch"):
                        launches += 1
        ops.sort(key=lambda o: o.start)
        host.sort(key=lambda h: h[1])
        self.prof = None
        return Trace(self.t0, self.t1, ops, host, launches)
