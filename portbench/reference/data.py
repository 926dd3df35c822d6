"""The benchmark's own inputs of a fit, made again from the seed: the image,
its corruption and the DIP net input.

Plain numpy, written from the upstream recipe (the reference repository's
data loaders and ``get_noise``) and kept apart from the program: the
checkout carries none of the upstream image files, so image 0 of each task
is its deterministic stand-in, the Shepp-Logan phantom for ct (scikit-image's
brain slice where that package is installed) and a synthetic chest X-ray for
den.
"""

from __future__ import annotations

import numpy as np


def _norm01(x: np.ndarray) -> np.ndarray:
    x = x - x.min()
    m = x.max()
    return (x / m if m > 0 else x).astype(np.float32)


def _smooth(x: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(x, sigma)


def shepp_logan(size: int) -> np.ndarray:
    """The Shepp-Logan head phantom (the standard ellipse table), (1, s, s)."""
    ellipses = [  # (value, a, b, x0, y0, phi_deg)
        (1.0, 0.69, 0.92, 0.0, 0.0, 0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0),
        (0.1, 0.046, 0.046, 0.0, -0.1, 0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0),
        (0.1, 0.023, 0.023, 0.0, -0.606, 0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0),
    ]
    yy, xx = np.mgrid[0:size, 0:size]
    x = (xx - (size - 1) / 2) / ((size - 1) / 2)
    y = ((size - 1) / 2 - yy) / ((size - 1) / 2)
    img = np.zeros((size, size), np.float32)
    for val, a, b, x0, y0, phi in ellipses:
        p = np.deg2rad(phi)
        xr = (x - x0) * np.cos(p) + (y - y0) * np.sin(p)
        yr = -(x - x0) * np.sin(p) + (y - y0) * np.cos(p)
        img += val * ((xr / a) ** 2 + (yr / b) ** 2 <= 1)
    return np.clip(img, 0, 1)[None]


def ct_image(size: int) -> np.ndarray:
    """Image 0 of the ct task: scikit-image's brain slice 4 scaled by 2^-16
    where the package is installed, else the phantom."""
    try:
        from skimage.data import brain
    except ImportError:
        return shepp_logan(size)
    return (brain()[4][None] / (2 ** 16)).astype(np.float32)


def xray_image(size: int, img: int = 0) -> np.ndarray:
    """Image ``img`` of the den task: smooth blobs, rib-like ripples and a
    vignette, from ``default_rng(1000 + img)``, (1, s, s) in [0, 1]."""
    rng = np.random.default_rng(1000 + img)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = _smooth(rng.standard_normal((size, size)), size / 16)
    ribs = 0.15 * np.sin(
        yy * 40 + 3 * _smooth(rng.standard_normal((size, size)), size / 8))
    vign = 1.0 - 0.8 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
    return _norm01(_norm01(base) * 0.6 + ribs + 0.3 * vign)[None]


def fit_inputs(cfg: dict, seed: int) -> dict:
    """The inputs of one fit of configuration ``cfg`` from ``seed``: the
    ground truth ``gt`` (C, H, W), the den target ``noisy`` (absent for ct)
    and the net input ``z`` (1, D, H, W), all float32. One numpy stream,
    ``default_rng(seed)``, draws the den noise and then the net input,
    uniform [0, 1) in (1, H, W, D) order times 0.1."""
    size = int(cfg["imsize"])
    rng = np.random.default_rng(seed)
    out = {}
    if cfg["task"] == "ct":
        out["gt"] = ct_image(size)
    elif cfg["task"] == "den":
        gt = xray_image(size, int(cfg.get("img", 0)))
        noisy = gt + rng.normal(scale=float(cfg["p_sigma"]), size=gt.shape)
        out["gt"] = gt
        out["noisy"] = np.clip(noisy, 0, 1).astype(np.float32)
    else:
        raise ValueError(f"no reference inputs for task {cfg['task']!r}")
    depth = int(cfg["input_depth"])
    z = rng.random((1, size, size, depth), dtype=np.float32) * 0.1
    out["z"] = np.ascontiguousarray(z.transpose(0, 3, 1, 2))
    return out
