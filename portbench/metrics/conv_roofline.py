"""conv_roofline (%, device trace; layer: Kernels): per iteration, the
least time of the net's conv sites (the sites its reference module lists;
forward, dx where needed, dw; operations at the configuration's tensor-core
peak, bytes at the HBM rate; see portbench/work/conv.py) over the device
time of the kernels that do that work in the traced stretch.

The kernels matched as conv work: the port's tensor-core conv kernels (the
forward and the input gradient of ``cf_conv``, its weight gradient, the
fused block's forward, weight and input gradients, the LRT double conv) and
cuDNN's convolution kernels. The fused block's BatchNorm backward (its dc
kernel) is not conv work; nor are cuBLAS GEMMs, which here are the
upsample's and SSIM's interpolation matrices."""

import re

from portbench.work import conv

PATTERNS = re.compile(
    r"conv_fwd_mma_kernel|conv_dw_mma_kernel|fused_fwd_mma_kernel"
    r"|fused_bwd_dw_mma_kernel|fused_bwd_dx_mma_kernel"
    r"|lrt_conv_fwd_mma_kernel"
    r"|fprop|dgrad|wgrad|implicit_convolve|convolve_|cudnn.*conv")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    replays = tr.replays()
    busy = sum(o.dur for o in tr.kernels() if PATTERNS.search(o.name))
    if not replays or busy <= 0:
        return None
    least = conv.least_seconds_per_iteration(run.config,
                                             run.cell.reference())
    return 100.0 * least / (busy / 1e9 / replays)
