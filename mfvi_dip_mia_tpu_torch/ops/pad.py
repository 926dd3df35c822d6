"""The conv sites' reflection pad, with a deterministic adjoint.

Counterpart of ``mfvi_dip_mia_tpu/nn/layers.py::reflection_pad`` and
``nn/cf.py::reflection_pad`` (``jnp.pad(..., mode="reflect")``), which JAX
computes outside any Pallas kernel. The forward is ``F.pad(...,
mode="reflect")``, a gather. PyTorch's own CUDA backward of it adds the
padded gradient into its input with atomics, so the same step gave other
bits on every call; this adjoint is a gather and fixed-order sums:

* one ``index_select`` of the padded gradient with a cached index gathers,
  for every input position, the padded positions that reflect onto it:
  ``mr`` row terms x ``mc`` column terms, the position itself first, then
  its mirror images (``mr = mc = 2`` unless an axis is shorter than
  ``2p + 2``);
* the column terms are summed first, then the row terms, each by one
  ``addcmul`` per extra term with a 0/1 mask of the terms that exist (a
  missing term repeats the position's own and is multiplied by 0), so a
  corner is ``(a + b) + (c + d)``.

Three kernel launches per backward call (``1 + (mr - 1) + (mc - 1)``),
where PyTorch's backward is a zero fill and one atomic kernel. No scatter,
no ``index_add_``, no atomics, no matrix product. The one way the result
differs from an exact sum: where a position's own term is +-inf, the masked
repeat of it turns the sum into NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import device_cache


def _axis_terms(n: int, p: int) -> tuple[list[list[int]], list[list[int]]]:
    """Of an axis of n positions reflect-padded by p on each side: for each
    term t and input position i, the padded position of term t (the
    position itself first, then its mirror images in ascending order; a
    missing term repeats the first) and whether the term exists."""
    onto = [[] for _ in range(n)]
    for j in range(n + 2 * p):
        t = j - p
        src = -t if t < 0 else (t if t < n else 2 * (n - 1) - t)
        onto[src].append(j)
    for i, js in enumerate(onto):
        js.remove(i + p)
        js.insert(0, i + p)
    m = max(len(js) for js in onto)
    terms = [[js[t] if t < len(js) else js[0] for js in onto]
             for t in range(m)]
    exists = [[int(t < len(js)) for js in onto] for t in range(m)]
    return terms, exists


@device_cache
def _tables(h: int, w: int, p: int, dtype: torch.dtype,
            device: torch.device):
    """(index (mr * mc * h * w,) into the flat padded plane, row-term masks
    (mr, h * w) and column-term masks (mc, h * w)) of an h x w input."""
    rows, row_ok = _axis_terms(h, p)
    cols, col_ok = _axis_terms(w, p)
    r = torch.tensor(rows)[:, None, :, None]           # (mr, 1, h, 1)
    c = torch.tensor(cols)[None, :, None, :]           # (1, mc, 1, w)
    index = (r * (w + 2 * p) + c).reshape(-1)
    mrow = torch.tensor(row_ok)[:, :, None].expand(-1, h, w).reshape(-1, h * w)
    mcol = torch.tensor(col_ok)[:, None, :].expand(-1, h, w).reshape(-1, h * w)
    return (index.to(device), mrow.to(device=device, dtype=dtype),
            mcol.to(device=device, dtype=dtype))


def reflection_pad_adjoint(g: torch.Tensor, p: int) -> torch.Tensor:
    """The gradient of the input of ``reflection_pad(x, p)`` from the
    gradient g (..., H + 2p, W + 2p) of its output: (..., H, W)."""
    *lead, hp, wp = g.shape
    h, w = hp - 2 * p, wp - 2 * p
    index, mrow, mcol = _tables(h, w, p, g.dtype, g.device)
    n = g.numel() // (hp * wp)
    t = g.reshape(n, hp * wp).index_select(1, index).view(
        n, mrow.shape[0], mcol.shape[0], h * w)
    s = t[:, :, 0]
    for c in range(1, mcol.shape[0]):
        s = torch.addcmul(s, t[:, :, c], mcol[c])
    out = s[:, 0]
    for r in range(1, mrow.shape[0]):
        out = torch.addcmul(out, s[:, r], mrow[r])
    return out.reshape(*lead, h, w)


class _ReflectionPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x, (p,) * 4, mode="reflect")

    @staticmethod
    def backward(ctx, g):
        return reflection_pad_adjoint(g, ctx.p), None


def reflection_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """torch ReflectionPad2d by p of x (C, H, W) or (1, C, H, W), whose
    gradient is ``reflection_pad_adjoint`` (deterministic). p must be below
    H and W, as ``F.pad`` requires."""
    if x.dim() not in (3, 4) or (x.dim() == 4 and x.shape[0] != 1):
        raise ValueError(f"(C, H, W) or (1, C, H, W) expected, got "
                         f"{tuple(x.shape)}")
    if p == 0:
        return x
    if not 0 < p < min(x.shape[-2], x.shape[-1]):
        raise ValueError(f"reflection pad {p} must be positive and below the "
                         f"input's height and width {tuple(x.shape[-2:])}")
    return _ReflectionPad.apply(x, p)
