"""Operations and bytes of the net's conv sites per iteration, from the
configuration's shapes alone (the reference net's topology,
portbench/reference/net.py).

For a site with I input and O output channels, a k x k kernel and an
Ho x Wo output: the forward, the input gradient (dx) and the weight gradient
(dw) each take 2 O I k^2 Ho Wo operations. Bytes count every input and
output once, whatever a kernel reads again: forward x, w in and y out; dx
dy, w in and dx out; dw x, dy in and dw out, in the precision's item size.
Level 0's skip and down1 sites read the net input, which needs no gradient,
so they have no dx.
"""

from __future__ import annotations

from ..reference.net import Net
from . import peaks


def sites(cfg: dict) -> list:
    """Every conv site as a dict: name, flops (one pass), bytes of the
    forward, dx and dw, and whether it needs dx."""
    net = Net.of(cfg)
    size = int(cfg["imsize"])
    item = peaks.ITEMSIZE[cfg["compute_dtype"]]
    out = []

    def add(s, s_in: int, needs_dx: bool):
        s_out = s_in // s.stride
        x = s.c_in * s_in * s_in
        y = s.c_out * s_out * s_out
        w = s.c_out * s.c_in * s.k * s.k
        flops = 2.0 * s.c_out * s.c_in * s.k * s.k * s_out * s_out
        out.append(dict(name=s.name, flops=flops, needs_dx=needs_dx,
                        fwd_bytes=item * (x + w + y),
                        dx_bytes=item * (y + w + x),
                        dw_bytes=item * (x + y + w)))

    for i in range(net.n_scales):
        lv = net.level_sites(i)
        s_in = size >> i
        if "skip" in lv:
            add(lv["skip"], s_in, i > 0)
        add(lv["down1"], s_in, i > 0)
        add(lv["down2"], s_in // 2, True)
        add(lv["up"], s_in, True)
        add(lv["up1x1"], s_in, True)
    add(net.out_site(), size, True)
    return out


def flops_per_iteration(cfg: dict) -> float:
    """Forward, dx (where needed) and dw operations of every site."""
    return sum(s["flops"] * (3 if s["needs_dx"] else 2) for s in sites(cfg))


def least_seconds_per_iteration(cfg: dict) -> float:
    """The sum over sites and passes of each pass's least time."""
    prec = cfg["compute_dtype"]
    total = 0.0
    for s in sites(cfg):
        total += peaks.least_seconds(s["flops"], s["fwd_bytes"], prec)
        total += peaks.least_seconds(s["flops"], s["dw_bytes"], prec)
        if s["needs_dx"]:
            total += peaks.least_seconds(s["flops"], s["dx_bytes"], prec)
    return total
