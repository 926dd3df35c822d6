"""The plain reference of the CT forward operator: rotate the image by each
projection angle with bilinear interpolation (zero outside the image, pixel
centres on the align_corners=False grid) and sum each rotated image over its
rows, (1, 1, H, W) -> sinogram (1, 1, T, W).

It is held as an explicit sparse matrix A (T*W, H*W), built once from the
geometry, so that its forward is A x and its adjoint A^T y, both in float32
through ``torch.sparse.mm``, and so that the work the discretised operator
needs can be read off it: its nonzero weights (``nnz``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def theta_deg(cfg: dict) -> np.ndarray:
    t = cfg["theta_deg"]
    return np.arange(float(t["start"]), float(t["stop"]), float(t["step"]))


def projection_matrix(theta: np.ndarray, size: int,
                      device="cpu") -> torch.Tensor:
    """A as a coalesced sparse COO float32 tensor on ``device``: entry
    (t*W + j, y*W + x) is the bilinear weight of pixel (y, x) in the sample
    of rotated pixel (i, j) at angle t, summed over the rows i; only
    positive weights are stored."""
    h = w = size
    f64 = dict(dtype=torch.float64, device=device)
    rad = torch.tensor(np.deg2rad(np.asarray(theta, np.float64)), **f64)
    jj = (2.0 * torch.arange(w, **f64) + 1.0) / w - 1.0
    ii = (2.0 * torch.arange(h, **f64) + 1.0) / h - 1.0
    x = jj[None, :].expand(h, w)
    y = ii[:, None].expand(h, w)
    rows, cols, vals = [], [], []
    col_of = torch.arange(w, device=device).expand(h, w)
    for t, th in enumerate(rad):
        c, s = torch.cos(th), torch.sin(th)
        ix = ((c * x - s * y + 1.0) * w - 1.0) / 2.0
        iy = ((s * x + c * y + 1.0) * h - 1.0) / 2.0
        x0, y0 = torch.floor(ix), torch.floor(iy)
        fx, fy = ix - x0, iy - y0
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            xc, yc = x0 + dx, y0 + dy
            ok = ((xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
                  & (wgt > 0))
            rows.append(t * w + col_of[ok])
            cols.append((yc[ok] * w + xc[ok]).long())
            vals.append(wgt[ok])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    a = torch.sparse_coo_tensor(idx, torch.cat(vals).float(),
                                (len(theta) * w, h * w),
                                check_invariants=False)
    return a.coalesce()


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, at, v):
        ctx.at = at
        return torch.sparse.mm(a, v)

    @staticmethod
    def backward(ctx, g):
        return None, None, torch.sparse.mm(ctx.at, g)


@functools.lru_cache(maxsize=4)
def operator(theta: tuple, size: int, device: str) -> "Radon":
    """The operator of ``theta`` (degrees) at ``size`` on ``device``, built
    once per process."""
    return Radon(np.asarray(theta), size, device)


class Radon:
    """A and its transpose on one device: ``op(img)`` maps (1, 1, H, W) to
    the sinogram (1, 1, T, W); its gradient is the adjoint."""

    def __init__(self, theta: np.ndarray, size: int, device="cpu"):
        self.a = projection_matrix(theta, size, device)
        self.at = self.a.t().coalesce()
        self.n_angles, self.size = len(theta), size

    @property
    def nnz(self) -> int:
        return int(self.a._nnz())

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        v = img.reshape(-1, 1).float()
        out = _Apply.apply(self.a, self.at, v)
        return out.reshape(1, 1, self.n_angles, self.size)
