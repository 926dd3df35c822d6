"""Hand-written CUDA kernels (csrc/) and their wrappers; see build.py.

Each wrapper counts its launches (``Kernel.count``). A CUDA graph's capture
calls the wrappers but runs nothing on the card, so the trainer takes a
capture's counts back off the counters (``take_counts_since``) and adds
them once per replay (``add_counts``): the counters count what the card
ran. Fits run concurrently on several threads (parallel/fanout.py), each
on a stream of its own, and a CUDA backward launches from PyTorch's
autograd thread onto the forward's stream, so a capture reads the tally of
its capture stream (``stream_counts``), not the process totals, which
every thread's launches and replays move; every count changes under
``build.COUNT_LOCK``."""

from . import build, cf_conv, fused_block, lrt_conv, radon_banded, radon_dense

KERNELS = (cf_conv.FWD, cf_conv.DW, radon_banded.FWD, radon_banded.ADJ,
           fused_block.FWD, fused_block.DC, fused_block.DW, fused_block.DX,
           lrt_conv.FWD, radon_dense.FWD, radon_dense.ADJ)


def reset_launches() -> None:
    with build.COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


def counts() -> tuple:
    """Every kernel's launch count over all threads, in KERNELS order."""
    with build.COUNT_LOCK:
        return tuple(k.launches for k in KERNELS)


def stream_counts(stream: int) -> tuple:
    """Every kernel's launches on ``stream`` (``build.stream_of``'s int) so
    far, in KERNELS order: the ``before`` of ``take_counts_since``."""
    with build.COUNT_LOCK:
        tally = build.stream_tally(stream)
        return tuple(tally.get(k.name, 0) for k in KERNELS)


def take_counts_since(before: tuple, stream: int) -> tuple:
    """The launches counted on ``stream`` since ``before`` (its
    ``stream_counts``), taken back off the process totals and returned;
    launches on other streams in the meantime stay counted."""
    with build.COUNT_LOCK:
        tally = build.stream_tally(stream)
        taken = tuple(tally.get(k.name, 0) - b
                      for k, b in zip(KERNELS, before))
        for k, n in zip(KERNELS, taken):
            k.launches -= n
    return taken


def add_counts(taken: tuple) -> None:
    """Count ``taken`` (a ``take_counts_since`` result) once more."""
    with build.COUNT_LOCK:
        for k, n in zip(KERNELS, taken):
            k.launches += n
