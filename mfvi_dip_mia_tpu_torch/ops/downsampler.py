"""Anti-aliased fixed-kernel downsampler (lanczos / gauss / box), NCHW
(counterpart of mfvi_dip_mia_tpu/ops/downsampler.py).

``get_kernel`` builds the reference's 2-D kernel (models/downsampler.py:
74-136) as the JAX package does, bit for bit, quirks included: gauss
distances are halved, phase 0.5 shrinks the grid by one sample, kernels
are sum-normalized. ``preserve_size`` replicate-pads so that the stride-f
output is exactly input / f.

JAX applies the kernel as a depthwise strided ``lax.conv_general_dilated``
(downsampler.py:98-111), outside any Pallas kernel. Every family here is
separable (the kernel is the outer product of one normalized profile), so
the port applies it as two f32 matrix products, rows then columns
(``nn/layers.py::apply_matrices``): the edge pad folds into the first and
last columns of each matrix, and a matrix product has one summation order,
so the forward and its backward are deterministic (no atomics, as
``F.pad(mode="replicate")``'s CUDA backward has, and no depthwise conv
algorithm choice). The matrices are built once per (size, device) and
cached (``_matrices_on``), so a CUDA graph's capture finds them built; so
are the row bands a row-split site applies to each shard (``band``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..nn.layers import apply_matrices, matrix_band
from ..utils.device import device_cache

KINDS = ("lanczos", "gauss", "box")


def _profile(factor: int, kernel_type: str, phase: float, kernel_width: int,
             support: int | None, sigma: float | None) -> np.ndarray:
    """The kernel's unnormalized 1-D profile (float64); box is constant."""
    if kernel_type == "box":
        assert phase == 0.5, "box filter is always half-phased"
        return np.ones(kernel_width, dtype=np.float64)
    n = kernel_width - 1 if phase == 0.5 else kernel_width
    center = (kernel_width + 1.0) / 2.0
    grid = np.arange(1, n + 1, dtype=np.float64)
    if kernel_type == "gauss":
        assert sigma, "sigma is not specified"
        assert phase != 0.5, "phase 1/2 for gauss not implemented"
        d = (grid - center) / 2.0
        return (np.exp(-d * d / (2.0 * sigma * sigma))
                / np.sqrt(2.0 * np.pi * sigma * sigma))
    # lanczos: sinc(d) * sinc(d / support), windowed
    assert support, "support is not specified"
    d = np.abs(grid + (0.5 if phase == 0.5 else 0.0) - center) / factor
    with np.errstate(invalid="ignore", divide="ignore"):
        profile = (support * np.sin(np.pi * d) * np.sin(np.pi * d / support)
                   / (np.pi * np.pi * d * d))
    profile[d == 0] = 1.0
    return profile


@functools.lru_cache(maxsize=None)
def get_kernel(factor: int, kernel_type: str, phase: float, kernel_width: int,
               support: int | None = None, sigma: float | None = None
               ) -> np.ndarray:
    """The separable 2-D anti-alias kernel (float32), the outer product of
    the 1-D profile, normalized to sum 1 (downsampler.py:20-57)."""
    assert kernel_type in KINDS
    if kernel_type == "box":
        assert phase == 0.5, "box filter is always half-phased"
        return np.full((kernel_width, kernel_width),
                       1.0 / kernel_width ** 2, dtype=np.float32)
    profile = _profile(factor, kernel_type, phase, kernel_width, support,
                       sigma)
    kernel = np.outer(profile, profile)
    kernel /= kernel.sum()
    return kernel.astype(np.float32)


_PRESETS = {
    "lanczos2": dict(support=2, kernel_type="lanczos",
                     width=lambda f: 4 * f + 1),
    "lanczos3": dict(support=3, kernel_type="lanczos",
                     width=lambda f: 6 * f + 1),
    "gauss12": dict(sigma=0.5, kernel_type="gauss", width=lambda f: 7),
    "gauss1sq2": dict(sigma=1.0 / np.sqrt(2), kernel_type="gauss",
                      width=lambda f: 9),
}


@functools.lru_cache(maxsize=None)
def _axis_matrix(size: int, taps: tuple, factor: int, pad: int
                 ) -> np.ndarray:
    """(out, size) f32 matrix of the 1-D VALID strided correlation with
    ``taps`` over the input edge-padded by ``pad`` on both sides: the
    padded sample i is the input's clamp(i - pad, 0, size - 1)."""
    k = len(taps)
    out = (size + 2 * pad - k) // factor + 1
    if out < 1:
        raise ValueError(f"input of {size} too small for a {k}-tap kernel")
    m = np.zeros((out, size), dtype=np.float64)
    for o in range(out):
        for t, v in enumerate(taps):
            m[o, min(max(o * factor + t - pad, 0), size - 1)] += v
    return m.astype(np.float32)


@device_cache
def _matrices_on(size: int, taps: tuple, factor: int, pad: int, device: str,
                 dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_axis_matrix(size, taps, factor, pad)).to(
        device=device, dtype=dtype)


@device_cache
def _band_on(size: int, taps: tuple, factor: int, pad: int, r0: int, r1: int,
             device: str, dtype: torch.dtype) -> tuple:
    band, c0, c1 = matrix_band(_axis_matrix(size, taps, factor, pad), r0, r1)
    return torch.from_numpy(band).to(device=device, dtype=dtype), c0, c1


class Downsampler:
    """Fixed anti-aliasing downsampler; call on NCHW input."""

    def __init__(self, n_planes: int, factor: int, kernel_type: str,
                 phase: float = 0.0, kernel_width: int | None = None,
                 support: int | None = None, sigma: float | None = None,
                 preserve_size: bool = False):
        assert phase in (0, 0.5)
        if kernel_type in _PRESETS:
            p = _PRESETS[kernel_type]
            support = p.get("support", support)
            sigma = p.get("sigma", sigma)
            kernel_width = p["width"](factor)
            kernel_type_ = p["kernel_type"]
        elif kernel_type in KINDS:
            kernel_type_ = kernel_type
        else:
            raise ValueError(f"wrong kernel name {kernel_type!r}")

        self.kernel = get_kernel(factor, kernel_type_, phase, kernel_width,
                                 support=support, sigma=sigma)
        profile = _profile(factor, kernel_type_, phase, kernel_width,
                           support, sigma)
        self.taps = tuple(float(v) for v in profile / profile.sum())
        self.factor = factor
        self.n_planes = n_planes
        self.preserve_size = preserve_size
        k = self.kernel.shape[0]
        self.pad = (k - 1) // 2 if k % 2 == 1 else (k - factor) // 2

    def matrices(self, h: int, w: int, device, dtype=torch.float32) -> tuple:
        """The (rows, columns) matrices for an h x w input on ``device``,
        built on the first call (before any capture) and cached."""
        pad = self.pad if self.preserve_size else 0
        return tuple(_matrices_on(n, self.taps, self.factor, pad, str(device),
                                  dtype) for n in (h, w))

    def band(self, h: int, r0: int, r1: int, device,
             dtype=torch.float32) -> tuple:
        """The output rows [r0, r1) of the row matrix for an h-row input,
        cut to the input rows [c0, c1) they read: (band, c0, c1), built on
        the first call and cached. A row-split pooled site (nn/sp.py::
        rows_by_matrix) applies it to a shard's rows and their halo."""
        pad = self.pad if self.preserve_size else 0
        return _band_on(h, self.taps, self.factor, pad, r0, r1, str(device),
                        dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mh, mw = self.matrices(x.shape[2], x.shape[3], x.device, x.dtype)
        return apply_matrices(x, mh, mw)
