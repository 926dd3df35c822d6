"""NCHW building blocks of the skip U-Net (counterpart of
mfvi_dip_mia_tpu/nn/layers.py and nn/cf.py, which collapse into this one op
set): train-mode BatchNorm with shifted one-pass moments, the activations
(LeakyReLU(0.2), ELU, Swish), the avg / max pools of a pooled down1 site,
the bilinear and nearest resizes (the x2 upsample, the sr operator), the
center-cropping concat, the 3-D conv and the input noise; reflection
padding is the conv site's (ops/kernels/cf_conv.py::conv2d_cf). Every
function takes batch-first NCHW tensors."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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


def elu(x: torch.Tensor) -> torch.Tensor:
    """where(x > 0, x, expm1(x)) (layers.py:104)."""
    return torch.where(x > 0, x, torch.expm1(x))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


_ACTIVATIONS = {
    "LeakyReLU": leaky_relu,
    "Swish": swish,
    "ELU": elu,
    "none": lambda x: x,
}


def activation(name: str):
    """The activation the skip net's ``act_fun`` names."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r} (one of "
                         f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]


# -- pooling (layers.py:129-137): non-overlapping k x k windows ----------------
# With the stride equal to the window, every input element lies in one
# window, so the backward writes each input gradient once: deterministic on
# the card as on the CPU.

def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """The mean of each k x k window (JAX's window sum / (k * k))."""
    return F.avg_pool2d(x, k)


def max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """The maximum of each k x k window. Its gradient goes to one element
    of the window: where several hold the maximum, the first in row-major
    order, as JAX's select-and-scatter with ``ge`` picks it."""
    return F.max_pool2d(x, k)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCDHW conv with an OIDHW kernel, torch cross-correlation semantics
    (layers.py:37-50, the Conv3d analog of the 3-D variational leaves).
    JAX computes it with lax.conv_general_dilated, outside any Pallas
    kernel, so this is the library's conv."""
    return F.conv3d(x, w, b, stride=stride, padding=padding)


def gen_noise(x: torch.Tensor, n_channels: int,
              generator: torch.Generator) -> torch.Tensor:
    """Standard-normal noise shaped like the NCHW ``x`` but with
    ``n_channels`` channels (layers.py:229; the reference's GenNoise)."""
    return torch.randn((x.shape[0], n_channels, *x.shape[2:]),
                       generator=generator, device=x.device, dtype=x.dtype)


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


def matrix_band(rows: np.ndarray, r0: int, r1: int) -> tuple:
    """The rows [r0, r1) of a resize matrix, cut to the columns [c0, c1)
    that hold their nonzero weights: (band, c0, c1). A row split resizes
    each shard's output rows from the input rows [c0, c1) alone (nn/sp.py);
    the weights it leaves out are zeros."""
    m = rows[r0:r1]
    nonzero = np.flatnonzero(m.any(axis=0))
    c0, c1 = int(nonzero[0]), int(nonzero[-1]) + 1
    return np.ascontiguousarray(m[:, c0:c1]), c0, c1


@device_cache
def band_on(mode: str, in_size: int, out_size: int, scale: float, r0: int,
            r1: int, device: str, dtype: torch.dtype) -> tuple:
    """``matrix_band`` of the ``mode`` resize matrix on ``device``:
    (band tensor, c0, c1)."""
    band, c0, c1 = matrix_band(_MATRICES[mode](in_size, out_size, scale),
                               r0, r1)
    return torch.from_numpy(band).to(device=device, dtype=dtype), c0, c1


def apply_matrices(x: torch.Tensor, mh: torch.Tensor,
                   mw: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, OH, OW): two matrix products, rows by the
    (OH, H) ``mh`` then columns by the (OW, W) ``mw``, in true f32 (TF32 off
    for them, as JAX's Precision.HIGHEST): a matrix product has one
    summation order, so the result and its backward are deterministic."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.einsum("oh,nchw->ncow", mh, x)
        return torch.einsum("pw,nchw->nchp", mw, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _resize_with_matrices(x: torch.Tensor, mode: str, scale: float,
                          out_hw) -> torch.Tensor:
    """Two interpolation-matrix products (``apply_matrices``)."""
    _, _, h, w = x.shape
    oh, ow = out_hw if out_hw is not None else (int(h * scale),
                                                int(w * scale))
    return apply_matrices(
        x, _matrix_on(mode, h, oh, scale, str(x.device), x.dtype),
        _matrix_on(mode, w, ow, scale, str(x.device), x.dtype))


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


def concat_center_crop(xs: list[torch.Tensor],
                       rows_split: bool = False) -> torch.Tensor:
    """Concat along channels, center-cropping to the smallest H and W.
    ``rows_split``: the inputs are one shard each of row-split activations
    (nn/sp.py), which can be cropped in their columns only; at the skip
    net's equal heights no row crop is due, and any other raises."""
    th = min(x.shape[2] for x in xs)
    if rows_split and any(x.shape[2] != th for x in xs):
        raise ValueError("a row-split concat needs inputs of one height, got "
                         f"{[x.shape[2] for x in xs]}")
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
