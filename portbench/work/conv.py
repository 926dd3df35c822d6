"""Operations and bytes of the net's conv sites per iteration, from the
configuration's shapes alone: the sites its reference module's
``conv_sites(cfg)`` lists (portbench/reference/<module>.py, the module the
configuration's ``reference`` names; ``spec.Cell.reference()`` loads it).

For a site with I input and O output channels, a k x k kernel, stride s and
an input of side n, the output's side is n // s, Ho x Wo; the forward, the
input gradient (dx) and the weight gradient (dw) each take 2 O I k^2 Ho Wo
operations. Bytes count every input and output once, whatever a kernel
reads again: forward x, w in and y out; dx dy, w in and dx out; dw x, dy in
and dw out, in the precision's item size. A site that reads the net input
needs no dx.
"""

from __future__ import annotations

from . import peaks


def sites(cfg: dict, ref) -> list:
    """Every conv site of ``ref.conv_sites(cfg)`` as a dict: name, flops
    (one pass), bytes of the forward, dx and dw, and whether it needs dx."""
    item = peaks.ITEMSIZE[cfg["compute_dtype"]]
    out = []
    for s in ref.conv_sites(cfg):
        s_in, s_out = s["size_in"], s["size_in"] // s["stride"]
        x = s["c_in"] * s_in * s_in
        y = s["c_out"] * s_out * s_out
        w = s["c_out"] * s["c_in"] * s["k"] * s["k"]
        flops = 2.0 * s["c_out"] * s["c_in"] * s["k"] * s["k"] * s_out * s_out
        out.append(dict(name=s["name"], flops=flops, needs_dx=s["needs_dx"],
                        fwd_bytes=item * (x + w + y),
                        dx_bytes=item * (y + w + x),
                        dw_bytes=item * (x + y + w)))
    return out


def flops_per_iteration(cfg: dict, ref) -> float:
    """Forward, dx (where needed) and dw operations of every site."""
    return sum(s["flops"] * (3 if s["needs_dx"] else 2)
               for s in sites(cfg, ref))


def least_seconds_per_iteration(cfg: dict, ref) -> float:
    """The sum over sites and passes of each pass's least time."""
    prec = cfg["compute_dtype"]
    total = 0.0
    for s in sites(cfg, ref):
        total += peaks.least_seconds(s["flops"], s["fwd_bytes"], prec)
        total += peaks.least_seconds(s["flops"], s["dw_bytes"], prec)
        if s["needs_dx"]:
            total += peaks.least_seconds(s["flops"], s["dx_bytes"], prec)
    return total
