"""Image quality metrics on the device (counterpart of
mfvi_dip_mia_tpu/ops/metrics.py), NCHW:

  * PSNR = 10*log10(1 / mse), images with max value 1
  * SSIM with an 11x11 Gaussian window (sigma 1.5), zero-padded, C1=0.01^2,
    C2=0.03^2; the separable blur runs as two banded-matrix products.
  * UCE, the uncertainty calibration error over equal-width uncertainty
    bins (metrics.py:102-140).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_cache


def psnr(image_true: torch.Tensor, image_test: torch.Tensor) -> torch.Tensor:
    err = torch.mean((image_true.float() - image_test.float()) ** 2)
    return 10.0 * torch.log10(1.0 / err)


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / float(2 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, window_size: int, sigma: float) -> np.ndarray:
    """(size, size) banded matrix B with B @ x == conv1d(x, g), zero padded."""
    g = _gaussian_window(window_size, sigma)
    pad = window_size // 2
    m = np.zeros((size, size), np.float32)
    for off in range(-pad, pad + 1):
        m += np.diag(np.full(size - abs(off), g[off + pad], np.float32), k=off)
    return m


@device_cache
def _blur_on(size: int, window_size: int, sigma: float,
             device: str) -> torch.Tensor:
    return torch.from_numpy(_blur_matrix(size, window_size, sigma)).to(device)


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    h, w = x.shape[2], x.shape[3]
    bh = _blur_on(h, window_size, sigma, str(x.device))
    bw = _blur_on(w, window_size, sigma, str(x.device))
    x = torch.einsum("oh,nchw->ncow", bh, x)
    return torch.einsum("pw,nchw->nchp", bw, x)


def ssim(image_true: torch.Tensor, image_test: torch.Tensor,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the image (including zero-padding border effects)."""
    x = image_true.float()
    y = image_test.float()
    c = x.shape[1]
    blurred = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=1),
                    window_size, sigma)
    mu1, mu2, exx, eyy, exy = (blurred[:, i * c:(i + 1) * c]
                               for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = exx - mu1_sq
    sigma2_sq = eyy - mu2_sq
    sigma12 = exy - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def uce(errors: torch.Tensor, uncert: torch.Tensor, n_bins: int = 15,
        outlier: float = 0.0, value_range=None) -> tuple:
    """Uncertainty Calibration Error on the tensors' device: the
    uncertainties binned into ``n_bins`` equal-width bins over
    ``value_range`` (default: their min and max; a bin is (lower, upper]),
    and |mean error - mean uncertainty| * the bin's share summed over the
    bins whose share is above ``outlier``.

    Returns (uce, err_in_bin, unc_in_bin, prop_in_bin), the per-bin tensors
    of length ``n_bins`` with NaN for the skipped bins. The bounds are JAX's
    linspace, lo * (1 - i/n) + hi * i/n in f32 with the last one hi."""
    errors = errors.reshape(-1).float()
    uncert = uncert.reshape(-1).float()
    if value_range is None:
        lo, hi = uncert.min(), uncert.max()
    else:
        lo, hi = (torch.tensor(v, dtype=torch.float32, device=uncert.device)
                  for v in value_range)
    t = torch.arange(n_bins, dtype=torch.float32,
                     device=uncert.device) / n_bins
    bounds = torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])
    lowers, uppers = bounds[:-1], bounds[1:]
    in_bin = ((uncert[None, :] > lowers[:, None])
              & (uncert[None, :] <= uppers[:, None])).float()
    count = in_bin.sum(dim=1)
    prop = count / uncert.shape[0]
    safe = torch.clamp(count, min=1.0)
    err_in_bin = (in_bin * errors[None, :]).sum(dim=1) / safe
    unc_in_bin = (in_bin * uncert[None, :]).sum(dim=1) / safe
    keep = prop > outlier
    total = torch.where(keep, (unc_in_bin - err_in_bin).abs() * prop,
                        0.0).sum()
    nan = torch.full_like(err_in_bin, float("nan"))
    return (total, torch.where(keep, err_in_bin, nan),
            torch.where(keep, unc_in_bin, nan), prop)
