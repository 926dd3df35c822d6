"""radon_roofline (%, device trace; layer: Problem / loss): per
iteration, the least time of the CT operator's forward and adjoint (two
operations per nonzero weight of the reference's discretised operator, the
image and the sinogram once each; portbench/work/radon.py) over the device
time of the kernels matched as Radon work in the traced stretch: the port's
banded and dense Radon kernels."""

import re

from portbench.work import radon

PATTERNS = re.compile(r"radon_fwd|radon_adj|radon_dense")


def read(run):
    tr = run.trace
    if tr is None or run.config.get("task") != "ct":
        return None
    replays = tr.replays()
    busy = sum(o.dur for o in tr.kernels() if PATTERNS.search(o.name))
    if not replays or busy <= 0:
        return None
    least = radon.least_seconds_per_iteration(run.config)
    return 100.0 * least / (busy / 1e9 / replays)
