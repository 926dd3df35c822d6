"""Process-wide serialization of the port's one-time work (counterpart of
mfvi_dip_mia_tpu/utils/compile_guard.py).

The JAX package serializes XLA compiles, so that the fanout's threads
(parallel/fanout.py) compile one at a time and then run concurrently. The
port's counterpart of a compile is what a fit does once before its first
replay: its eager warm-up plus CUDA-graph capture (tasks/trainer.py::
capture_steps, bayes/uncertainty.py::_replayed, utils/graphs.py::capture).
Each holds ``LOCK``; replays and eager steps take no lock, so fits on
other threads keep running while one captures.

One capture at a time is what keeps the capture safe: ``torch.cuda.graph``
synchronizes the whole device, collects garbage and empties the
allocator's cache when it starts, and a warm-up fills the tables the other
fits read. The lock is reentrant (a capture inside a warm-up's block takes
it again). Nothing that PyTorch's autograd thread runs for the backward of
a warm-up or capture takes it, since the capturing thread holds it while it
waits for that backward: the kernels' nvcc build (ops/kernels/build.py),
the ``device_cache`` tables (utils/device.py) and the dw ticket buffers
(ops/kernels/cf_conv.py) have locks of their own, held only while one
entry is made.
"""

from __future__ import annotations

import threading

LOCK = threading.RLock()
