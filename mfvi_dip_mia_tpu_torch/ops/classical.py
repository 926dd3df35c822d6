"""Classical (non-deep-learning) baselines of the evaluation report, on the
device in float64 (counterpart of mfvi_dip_mia_tpu/ops/classical.py, which
runs them in numpy float64 on the host):

  * TV denoising (Chambolle's dual projection, as skimage's
    denoise_tv_chambolle)
  * the bilateral filter
  * wavelet denoising (Haar, BayesShrink soft thresholds, as skimage's
    denoise_wavelet default)
  * bicubic upscaling, as two separable interpolation matrices with PIL's
    bicubic kernel (a = -0.5) in place of JAX's PIL call
  * FBP lives in ops/radon.py

Each takes a (C, H, W) image in [0, 1] (numpy or a tensor) and ``device``
(default: the card; utils/device.py::resolve_device) and returns a float32
(C, H, W) tensor there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device


def _on(img, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                           else img).to(device=resolve_device(device),
                                        dtype=dtype)


def tv_denoise_chambolle(img, weight: float = 0.1, eps: float = 2e-4,
                         max_iter: int = 200, device=None) -> torch.Tensor:
    """Chambolle's projection algorithm for the ROF model, per channel.
    Its stopping test (the largest change of u below ``eps``) reads one
    number back to the host per iteration, at most ``max_iter`` per
    channel: fine for an evaluation, never inside a fit."""
    x = _on(img, device, torch.float64)
    tau = 0.25

    def one(u0):
        p = torch.zeros((2,) + u0.shape, dtype=u0.dtype, device=u0.device)
        u = u0.clone()
        last = None
        for _ in range(max_iter):
            div = torch.zeros_like(u0)
            div[:-1] += p[0, :-1]
            div[1:] -= p[0, :-1]
            div[:, :-1] += p[1, :, :-1]
            div[:, 1:] -= p[1, :, :-1]
            u = u0 - weight * div
            gx = torch.zeros_like(u0)
            gy = torch.zeros_like(u0)
            gx[:-1] = u[1:] - u[:-1]
            gy[:, :-1] = u[:, 1:] - u[:, :-1]
            norm = torch.sqrt(gx ** 2 + gy ** 2)
            denom = 1.0 + (tau / weight) * norm
            p[0] = (p[0] - (tau / weight) * gx) / denom
            p[1] = (p[1] - (tau / weight) * gy) / denom
            change = (math.inf if last is None
                      else float((u - last).abs().max()))
            last = u.clone()
            if change < eps:
                break
        return u

    return torch.stack([one(c) for c in x]).float()


def bilateral_denoise(img, sigma_spatial: float = 2.0,
                      sigma_color: float = 0.1, radius: int = 5,
                      device=None) -> torch.Tensor:
    """Brute-force bilateral filter over the (2 radius + 1)^2 circular
    shifts. As in JAX's numpy version the colour weight is computed in the
    image's float32 and the sums in float64."""
    x = _on(img, device, torch.float32)
    out = []
    for c in x:
        acc = torch.zeros(c.shape, dtype=torch.float64, device=c.device)
        norm = torch.zeros_like(acc)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                w_s = math.exp(-(dy * dy + dx * dx)
                               / (2 * sigma_spatial ** 2))
                shifted = torch.roll(c, (dy, dx), (0, 1))
                w_c = torch.exp(-((shifted - c) ** 2)
                                / (2 * sigma_color ** 2))
                w = w_s * w_c.double()
                acc += w * shifted
                norm += w
        out.append(acc / norm)
    return torch.stack(out).float()


def _haar_2d(x):
    a = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) / 2
    h = (x[0::2, 0::2] - x[0::2, 1::2] + x[1::2, 0::2] - x[1::2, 1::2]) / 2
    v = (x[0::2, 0::2] + x[0::2, 1::2] - x[1::2, 0::2] - x[1::2, 1::2]) / 2
    d = (x[0::2, 0::2] - x[0::2, 1::2] - x[1::2, 0::2] + x[1::2, 1::2]) / 2
    return a, (h, v, d)


def _ihaar_2d(a, hvd):
    h, v, d = hvd
    x = torch.zeros((a.shape[0] * 2, a.shape[1] * 2), dtype=a.dtype,
                    device=a.device)
    x[0::2, 0::2] = (a + h + v + d) / 2
    x[0::2, 1::2] = (a - h + v - d) / 2
    x[1::2, 0::2] = (a + h - v - d) / 2
    x[1::2, 1::2] = (a - h - v + d) / 2
    return x


def _median(x: torch.Tensor) -> torch.Tensor:
    """np.median: the mean of the two middle values of an even count
    (torch.median returns the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2


def wavelet_denoise(img, levels: int = 3, device=None) -> torch.Tensor:
    """Haar wavelet soft thresholding with BayesShrink per-subband
    thresholds; the noise sigma from the finest diagonal subband's median
    absolute value (MAD)."""
    x = _on(img, device, torch.float64)

    def one(c):
        coeffs = []
        a = c
        for _ in range(levels):
            a, hvd = _haar_2d(a)
            coeffs.append(hvd)
        sigma = _median(coeffs[0][2].abs()) / 0.67448975
        var_n = sigma ** 2

        def shrink(band):
            var_y = torch.clamp(torch.mean(band ** 2), min=1e-12)
            var_x = torch.clamp(var_y - var_n, min=1e-12)
            thresh = var_n / torch.sqrt(var_x)
            return torch.sign(band) * torch.clamp(band.abs() - thresh,
                                                  min=0.0)

        coeffs = [tuple(shrink(b) for b in hvd) for hvd in coeffs]
        for hvd in reversed(coeffs):
            a = _ihaar_2d(a, hvd)
        return a

    return torch.stack([one(c) for c in x]).float()


def _bicubic_weight(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of PIL's bicubic resample along one
    axis: output x samples around the centre (x + 0.5) * n_in / n_out,
    taps truncated at the border and renormalized (Resample.c)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((n_out, n_in))
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        w = np.array([_bicubic_weight((x - center + 0.5) / fscale)
                      for x in range(lo, hi)])
        m[xx, lo:hi] = w / w.sum()
    return m


def bicubic_upscale(img, factor: int, device=None) -> torch.Tensor:
    """Bicubic x``factor`` upscale (the compare_super-resolution.ipynb
    baseline): rows of each channel through PIL's horizontal pass, then
    its vertical one, each clipped to [0, 1] as PIL clips. Without JAX's
    uint16 round trip it differs from PIL by at most 2 / 65535 where PIL
    does not saturate (above 65535 PIL's 16-bit pass keeps only the low
    byte under a 0xFF high byte)."""
    x = _on(img, device, torch.float64).clamp(0.0, 1.0)
    _, h, w = x.shape
    mh = torch.from_numpy(bicubic_matrix(h, h * factor)).to(x.device)
    mw = torch.from_numpy(bicubic_matrix(w, w * factor)).to(x.device)
    rows = torch.clamp(torch.einsum("chw,pw->chp", x, mw), 0.0, 1.0)
    return torch.clamp(torch.einsum("oh,chp->cop", mh, rows), 0.0,
                       1.0).float()
