"""Hand-written CUDA kernels (csrc/) and their wrappers; see build.py."""

from . import cf_conv, fused_block, radon_banded

KERNELS = (cf_conv.FWD, cf_conv.DW, radon_banded.FWD, radon_banded.ADJ,
           fused_block.FWD, fused_block.DC, fused_block.DW, fused_block.DX)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
