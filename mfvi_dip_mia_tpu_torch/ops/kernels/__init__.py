"""Hand-written CUDA kernels (csrc/) and their wrappers; see build.py."""

from . import cf_conv, fused_block, lrt_conv, radon_banded, radon_dense

KERNELS = (cf_conv.FWD, cf_conv.DW, radon_banded.FWD, radon_banded.ADJ,
           fused_block.FWD, fused_block.DC, fused_block.DW, fused_block.DX,
           lrt_conv.FWD, radon_dense.FWD, radon_dense.ADJ)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
