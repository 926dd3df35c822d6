"""Hand-written CUDA kernels (csrc/) and their wrappers; see build.py.

Each wrapper counts its launches. A CUDA graph's capture calls the wrappers
but runs nothing on the card, so the trainer takes a capture's counts back
off the counters (``take_counts_since``) and adds them once per replay
(``add_counts``): the counters count what the card ran."""

from . import cf_conv, fused_block, lrt_conv, radon_banded, radon_dense

KERNELS = (cf_conv.FWD, cf_conv.DW, radon_banded.FWD, radon_banded.ADJ,
           fused_block.FWD, fused_block.DC, fused_block.DW, fused_block.DX,
           lrt_conv.FWD, radon_dense.FWD, radon_dense.ADJ)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> tuple:
    """Every kernel's launch count, in KERNELS order."""
    return tuple(k.launches for k in KERNELS)


def take_counts_since(before: tuple) -> tuple:
    """The launches counted since ``before`` (a ``counts()``), taken back off
    the counters and returned."""
    taken = tuple(k.launches - n for k, n in zip(KERNELS, before))
    for k, n in zip(KERNELS, before):
        k.launches = n
    return taken


def add_counts(taken: tuple) -> None:
    """Count ``taken`` (a ``take_counts_since`` result) once more."""
    for k, n in zip(KERNELS, taken):
        k.launches += n
