"""The CT forward operator (counterpart of mfvi_dip_mia_tpu/ops/radon.py).

Rotate the image by each projection angle with bilinear interpolation on the
affine_grid / grid_sample (align_corners=False, zero padding) convention,
then sum over rows: (B, C, H, W) -> sinogram (B, C, T, W), the reference's
NCHW layout.

Modes:
  * 'banded'      — the block-banded operator on the card's band kernels,
                    exact f32 band (ops/kernels/radon_banded.py)
  * 'banded-bf16' — the same kernels on a bf16-stored band (half the bytes)
  * 'dense-bf16'  — the dense projection matrix stored in bf16 on the dense
                    matvec kernels (ops/kernels/radon_dense.py): JAX's
                    'pallas' mode
  * 'matmul'      — the dense exact f32 projection matrix
  * 'gather'      — the coordinate-generating bilinear gather (plain torch;
                    autograd gives its adjoint)
  * 'auto'        — 'banded-bf16' on the card when the image size allows (as
                    the TPU default picks), else 'matmul'

Also here: ``adjoint`` (the exact A^T through autograd of the forward) and
the classical filtered backprojection ``fbp`` of the eval tooling.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kernels import radon_banded as rb
from .kernels import radon_dense as rd
from ..utils.device import device_cache, resolve_device

MODES = ("banded", "banded-bf16", "dense-bf16", "matmul", "gather")


def _rotation_coords(theta_rad: torch.Tensor, h: int, w: int):
    """Pixel-space sample coordinates (ix, iy), each (T, h, w) f32, of
    rotating an (h, w) image by each angle on torch's affine_grid /
    grid_sample align_corners=False mapping (radon.py::_rotation_coords)."""
    dev = theta_rad.device
    jj = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
    ii = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
    x = jj[None, :].expand(h, w)
    y = ii[:, None].expand(h, w)
    c = torch.cos(theta_rad)[:, None, None]
    s = torch.sin(theta_rad)[:, None, None]
    gx = c * x[None] - s * y[None]
    gy = s * x[None] + c * y[None]
    return ((gx + 1.0) * w - 1.0) / 2.0, ((gy + 1.0) * h - 1.0) / 2.0


def _bilinear_gather(img: torch.Tensor, ix: torch.Tensor,
                     iy: torch.Tensor) -> torch.Tensor:
    """Sample (N, h, w) image planes at float coords (T, h, w) with bilinear
    interpolation and zero padding (radon.py::_bilinear_gather). Returns
    (N, T, h, w)."""
    n, h, w = img.shape
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    flat = img.reshape(n, h * w)

    def corner(yc, xc, wgt):
        valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        xi = torch.clamp(xc, 0, w - 1).long()
        yi = torch.clamp(yc, 0, h - 1).long()
        vals = flat[:, yi * w + xi]                        # (N, T, h, w)
        return vals * (wgt * valid.to(img.dtype))

    return (corner(y0, x0, (1 - fx) * (1 - fy))
            + corner(y0, x0 + 1, fx * (1 - fy))
            + corner(y0 + 1, x0, (1 - fx) * fy)
            + corner(y0 + 1, x0 + 1, fx * fy))


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


def dense_matrix_bf16(theta_deg, h: int, w: int, device) -> torch.Tensor:
    """The bf16 projection matrix of ``theta_deg`` on ``device`` (cached)."""
    return _dense_matrix(tuple(np.asarray(theta_deg, np.float64).tolist()),
                         h, w, str(torch.device(device)))


# The dense bf16 matrix, built once per process (radon.py:205-225 caches it
# the same way): (angles, H, W, device) -> (T*W, H*W) bf16 on the device
@device_cache
def _dense_matrix(theta: tuple, h: int, w: int, device: str) -> torch.Tensor:
    return rd.prepare_matrix_bf16(_build_projection_matrix(theta, h, w),
                                  device)


class FastRadonTransform:
    """Static-config Radon operator: ``op(image) -> sinogram`` with image
    (B, C, H, W), H == W, and sinogram (B, C, T, W); ``theta`` in degrees.
    The operator's state (band or matrix) is built once, on ``device``: the
    card unless the caller asks for the CPU (``device="cpu"``); without a
    card the default raises."""

    MATMUL_BUDGET_BYTES = 4 * 1024 ** 3

    def __init__(self, image_size, theta, mode: str = "auto", device=None):
        h, w = int(image_size[-2]), int(image_size[-1])
        if h != w:
            raise ValueError("Radon operator expects square images")
        self.theta_deg = np.asarray(theta, np.float32)
        self.h, self.w = h, w
        self.n_angles = len(self.theta_deg)
        self.device = resolve_device(device)
        if mode == "auto":
            banded_ok = (w >= rb.auto_jwin(rb.PATCH) and h % rb.PATCH == 0)
            mode = ("banded-bf16" if self.device.type == "cuda" and banded_ok
                    else "matmul")
        if mode not in MODES:
            raise ValueError(f"unknown Radon mode {mode!r}")
        if mode == "matmul" and self.matrix_bytes > self.MATMUL_BUDGET_BYTES:
            raise ValueError(f"dense matrix of {self.matrix_bytes} bytes "
                             "exceeds the budget; use mode='banded'")
        self.mode = mode
        if mode == "matmul":
            self.state = torch.from_numpy(_build_projection_matrix(
                self.theta_deg, h, w)).to(self.device)
        elif mode == "dense-bf16":
            self.state = dense_matrix_bf16(self.theta_deg, h, w, self.device)
        elif mode == "gather":
            self.state = torch.from_numpy(np.deg2rad(self.theta_deg)).to(
                self.device)
        else:
            dt = torch.bfloat16 if mode == "banded-bf16" else torch.float32
            self.state = rb.prepare_banded_direct(self.theta_deg, h, w,
                                                  dtype=dt, device=self.device)

    @property
    def matrix_bytes(self) -> int:
        return self.n_angles * self.w * self.h * self.w * 4

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        b, c, h, w = image.shape
        if self.mode == "matmul":
            flat = image.float().reshape(b * c, h * w)
            sino = flat @ self.state.T                    # (B*C, T*W)
            return sino.reshape(b, c, self.n_angles, self.w)
        if self.mode == "dense-bf16":
            return rd.radon_apply_dense(image, self.state, self.n_angles)
        if self.mode == "gather":
            ix, iy = _rotation_coords(self.state, self.h, self.w)
            rot = _bilinear_gather(image.reshape(b * c, h, w), ix, iy)
            return rot.sum(dim=2).reshape(b, c, self.n_angles, w)
        return rb.radon_apply_banded(image, self.state)

    def adjoint(self, sinogram: torch.Tensor) -> torch.Tensor:
        """Exact adjoint A^T (unfiltered backprojection) through autograd of
        the forward (radon.py::adjoint): (B, C, T, W) -> (B, C, H, W)."""
        zero = torch.zeros((sinogram.shape[0], sinogram.shape[1], self.h,
                            self.w), dtype=torch.float32,
                           device=sinogram.device, requires_grad=True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(self(zero), zero,
                                          sinogram.float())
        return grad


def _fbp_ramp_filter(sino_tw: torch.Tensor, w: int) -> torch.Tensor:
    """Shepp-Logan-filtered sinogram rows (radon.py::_fbp_ramp_filter):
    ramp * sinc in the frequency domain, zero-padded to a power of two."""
    n = int(2 ** np.ceil(np.log2(2 * w)))
    freqs = torch.fft.rfftfreq(n, device=sino_tw.device)
    window = 2.0 * freqs.abs() * torch.sinc(freqs)
    f = torch.fft.rfft(sino_tw, n=n, dim=-1) * window
    return torch.fft.irfft(f, n=n, dim=-1)[..., :w]


def fbp(sinogram: torch.Tensor, theta_deg, output_size: int) -> torch.Tensor:
    """Filtered backprojection baseline (radon.py::fbp): the Shepp-Logan
    filter and a linear-interpolation backprojection on skimage.iradon's
    coordinate convention. (B, C, T, W) sinogram -> (B, C, s, s) image."""
    b, c, t, w = sinogram.shape
    dev = sinogram.device
    theta = torch.from_numpy(np.deg2rad(np.asarray(theta_deg, np.float32))
                             ).to(dev)
    filtered = _fbp_ramp_filter(sinogram.float().reshape(b * c * t, w),
                                w).reshape(b * c, t, w)
    s = output_size
    grid = torch.arange(s, dtype=torch.float32, device=dev) - (s - 1) / 2.0
    ygrid, xgrid = torch.meshgrid(grid, grid, indexing="ij")
    acc = torch.zeros((b * c, s, s), dtype=torch.float32, device=dev)
    for k in range(t):                       # the JAX scan over angles
        th = theta[k] + math.pi / 2
        pos = xgrid * torch.cos(th) + ygrid * torch.sin(th) + (w - 1) / 2.0
        i0 = torch.clamp(torch.floor(pos), 0, w - 2)
        frac = pos - i0
        i0 = i0.long()
        row = filtered[:, k]
        vals = row[:, i0] * (1 - frac) + row[:, i0 + 1] * frac
        inside = (pos >= 0) & (pos <= w - 1)
        acc = acc + torch.where(inside, vals, torch.zeros_like(vals))
    return (acc * math.pi / (2.0 * t)).reshape(b, c, s, s)
