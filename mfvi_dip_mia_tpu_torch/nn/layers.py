"""NCHW building blocks of the skip U-Net (counterpart of
mfvi_dip_mia_tpu/nn/layers.py and nn/cf.py, which collapse into this one op
set): train-mode BatchNorm with shifted one-pass moments, LeakyReLU(0.2),
the bilinear and nearest resizes (the x2 upsample, the sr operator), and
the center-cropping concat; reflection padding is the conv site's
(ops/kernels/cf_conv.py::conv2d_cf). Every function takes batch-first NCHW
tensors."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_cache


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     offset: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in train mode (biased batch statistics over N, H, W) with
    the shifted one-pass moments of nn/cf.py::batch_norm_train: a per-channel
    shift c from the first 8 rows (no gradient) keeps E[(x-c)^2] - E[x-c]^2
    free of the f32 cancellation a large channel mean causes. Statistics in
    f32; the normalization is one multiply-add in x's dtype."""
    xf = x.float()
    c = xf[:, :, :8, :].mean(dim=(0, 2, 3), keepdim=True).detach()
    xc = xf - c
    mean_c = xc.mean(dim=(0, 2, 3), keepdim=True)
    ex2 = (xc * xc).mean(dim=(0, 2, 3), keepdim=True)
    var = torch.clamp(ex2 - mean_c * mean_c, min=0.0)
    mean = c + mean_c
    inv = torch.rsqrt(var + eps)
    sc = scale[None, :, None, None].float()
    a = (inv * sc).to(x.dtype)
    b = (offset[None, :, None, None].float() - mean * inv * sc).to(x.dtype)
    return x * a + b


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """where(x >= 0, x, slope * x), with the JAX package's gradient at 0."""
    return torch.where(x >= 0, x, negative_slope * x)


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) row-stochastic interpolation matrix with torch's
    align_corners=False mapping src = (dst + 0.5) / scale - 0.5, clamped
    (layers.py::_bilinear_matrix)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float64)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), i0] += (1.0 - frac).astype(np.float32)
    m[np.arange(out_size), i1] += frac.astype(np.float32)
    return m


@functools.lru_cache(maxsize=None)
def _nearest_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) 0/1 matrix with torch's legacy 'nearest' mapping
    src = floor(dst / scale) (layers.py::_nearest_matrix)."""
    dst = np.arange(out_size, dtype=np.float64)
    src = np.minimum((dst / scale).astype(np.int64), in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), src] = 1.0
    return m


_MATRICES = {"bilinear": _bilinear_matrix, "nearest": _nearest_matrix}


@device_cache
def _matrix_on(mode: str, in_size: int, out_size: int, scale: float,
               device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_MATRICES[mode](in_size, out_size, scale)).to(
        device=device, dtype=dtype)


def _resize_with_matrices(x: torch.Tensor, mode: str, scale: float,
                          out_hw) -> torch.Tensor:
    """Two interpolation-matrix products, rows then columns, in true f32
    (TF32 off for them, as JAX's Precision.HIGHEST): a matrix product has
    one summation order, so the resize and its backward are deterministic."""
    _, _, h, w = x.shape
    oh, ow = out_hw if out_hw is not None else (int(h * scale),
                                                int(w * scale))
    mh = _matrix_on(mode, h, oh, scale, str(x.device), x.dtype)
    mw = _matrix_on(mode, w, ow, scale, str(x.device), x.dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.einsum("oh,nchw->ncow", mh, x)
        return torch.einsum("pw,nchw->nchp", mw, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def resize_bilinear(x: torch.Tensor, scale: float,
                    out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """F.interpolate(x, scale_factor=scale, mode='bilinear',
    align_corners=False, recompute_scale_factor=False), to ``out_hw`` if
    given."""
    return _resize_with_matrices(x, "bilinear", scale, out_hw)


def resize_nearest(x: torch.Tensor, scale: float,
                   out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """F.interpolate(..., mode='nearest'). x2 to twice the size is the
    exact out[i] = in[i // 2], as a broadcast and a copy (its backward a
    plain sum, no scatter); other scales are 0/1-matrix products."""
    n, c, h, w = x.shape
    oh, ow = out_hw if out_hw is not None else (int(h * scale),
                                                int(w * scale))
    if scale == 2.0 and oh == 2 * h and ow == 2 * w:
        return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
            n, c, oh, ow)
    return _resize_with_matrices(x, "nearest", scale, (oh, ow))


def upsample2x(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bilinear":
        return resize_bilinear(x, 2.0)
    if mode == "nearest":
        return resize_nearest(x, 2.0)
    raise ValueError(f"unknown upsample mode {mode!r}")


def concat_center_crop(xs: list[torch.Tensor]) -> torch.Tensor:
    """Concat along channels, center-cropping to the smallest H and W."""
    th = min(x.shape[2] for x in xs)
    tw = min(x.shape[3] for x in xs)
    cropped = []
    for x in xs:
        dh = (x.shape[2] - th) // 2
        dw = (x.shape[3] - tw) // 2
        cropped.append(x[:, :, dh:dh + th, dw:dw + tw])
    return torch.cat(cropped, dim=1)


def dropout_keep(shape, keep_prob: float,
                 generator: torch.Generator) -> torch.Tensor:
    """The boolean keep mask of one dropout draw (True with probability
    ``keep_prob``), on the generator's device. Every dropout mask is drawn
    here, so a caller can hold dropout to a fixed mask; JAX draws
    bernoulli(key, 1 - p) (layers.py:216-227)."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device) < keep_prob


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Element-wise dropout with 1/(1-p) scaling (F.dropout, training=True),
    in JAX's order of operations: where(keep, x / (1 - p), 0)."""
    keep = dropout_keep(x.shape, 1.0 - p, generator)
    return torch.where(keep, x / (1.0 - p), 0.0)


def dropout2d(x: torch.Tensor, p: float,
              generator: torch.Generator) -> torch.Tensor:
    """Channel dropout (F.dropout2d): one draw per (sample, channel) of an
    NCHW tensor zeroes or keeps the whole map, scaled by 1/(1-p)."""
    keep = dropout_keep((x.shape[0], x.shape[1], 1, 1), 1.0 - p, generator)
    return torch.where(keep, x / (1.0 - p), 0.0)
