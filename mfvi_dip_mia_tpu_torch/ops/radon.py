"""The CT forward operator (counterpart of mfvi_dip_mia_tpu/ops/radon.py).

Rotate the image by each projection angle with bilinear interpolation on the
affine_grid / grid_sample (align_corners=False, zero padding) convention,
then sum over rows: (B, C, H, W) -> sinogram (B, C, T, W), the reference's
NCHW layout.

Modes:
  * 'banded'      — the block-banded operator on the card's band kernels,
                    exact f32 band (ops/kernels/radon_banded.py)
  * 'banded-bf16' — the same kernels on a bf16-stored band (half the bytes)
  * 'matmul'      — the dense exact f32 projection matrix
  * 'auto'        — 'banded-bf16' on the card when the image size allows (as
                    the TPU default picks), else 'matmul'
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import radon_banded as rb


def _build_projection_matrix(theta_deg, h: int, w: int) -> np.ndarray:
    """Dense A with A[t*W + j, y*W + x] = the bilinear rotate-and-sum weight
    of pixel (y, x) on sinogram bin (t, j) (radon.py::_build_projection_matrix)."""
    theta_rad = np.deg2rad(np.asarray(theta_deg, np.float64))
    t_count = len(theta_rad)

    jj = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ii = (2.0 * np.arange(h) + 1.0) / h - 1.0
    x = np.broadcast_to(jj[None, :], (h, w))
    y = np.broadcast_to(ii[:, None], (h, w))

    a = np.zeros((t_count * w, h * w), np.float32)
    rows = np.broadcast_to(np.arange(w)[None, :], (h, w)).ravel()

    for t, th in enumerate(theta_rad):
        c, s = np.cos(th), np.sin(th)
        gx = c * x - s * y
        gy = s * x + c * y
        ix = ((gx + 1.0) * w - 1.0) / 2.0
        iy = ((gy + 1.0) * h - 1.0) / 2.0
        x0 = np.floor(ix)
        y0 = np.floor(iy)
        fx = (ix - x0).ravel()
        fy = (iy - y0).ravel()
        x0 = x0.ravel().astype(np.int64)
        y0 = y0.ravel().astype(np.int64)
        block = a[t * w:(t + 1) * w]
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)),
                            (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy),
                            (1, 1, fx * fy)):
            xc, yc = x0 + dx, y0 + dy
            valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            np.add.at(block,
                      (rows[valid], yc[valid] * w + xc[valid]),
                      wgt[valid].astype(np.float32))
    return a


class FastRadonTransform:
    """Static-config Radon operator: ``op(image) -> sinogram`` with image
    (B, C, H, W), H == W, and sinogram (B, C, T, W); ``theta`` in degrees.
    The operator's state (band or matrix) is built once, on ``device``."""

    MATMUL_BUDGET_BYTES = 4 * 1024 ** 3

    def __init__(self, image_size, theta, mode: str = "auto", device="cpu"):
        h, w = int(image_size[-2]), int(image_size[-1])
        if h != w:
            raise ValueError("Radon operator expects square images")
        self.theta_deg = np.asarray(theta, np.float32)
        self.h, self.w = h, w
        self.n_angles = len(self.theta_deg)
        self.device = torch.device(device)
        if mode == "auto":
            banded_ok = (w >= rb.auto_jwin(rb.PATCH) and h % rb.PATCH == 0)
            mode = ("banded-bf16" if self.device.type == "cuda" and banded_ok
                    else "matmul")
        if mode not in ("banded", "banded-bf16", "matmul"):
            raise ValueError(f"unknown Radon mode {mode!r}")
        if mode == "matmul" and self.matrix_bytes > self.MATMUL_BUDGET_BYTES:
            raise ValueError(f"dense matrix of {self.matrix_bytes} bytes "
                             "exceeds the budget; use mode='banded'")
        self.mode = mode
        if mode == "matmul":
            self.state = torch.from_numpy(_build_projection_matrix(
                self.theta_deg, h, w)).to(self.device)
        else:
            dt = torch.bfloat16 if mode == "banded-bf16" else torch.float32
            self.state = rb.prepare_banded_direct(self.theta_deg, h, w,
                                                  dtype=dt, device=self.device)

    @property
    def matrix_bytes(self) -> int:
        return self.n_angles * self.w * self.h * self.w * 4

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        if self.mode == "matmul":
            b, c, h, w = image.shape
            flat = image.float().reshape(b * c, h * w)
            sino = flat @ self.state.T                    # (B*C, T*W)
            return sino.reshape(b, c, self.n_angles, self.w)
        return rb.radon_apply_banded(image, self.state)
