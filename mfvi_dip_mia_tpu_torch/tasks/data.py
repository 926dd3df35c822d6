"""Task data with deterministic synthetic fallbacks (counterpart of
mfvi_dip_mia_tpu/tasks/data.py, for the four tasks).

The reference's data directory is not distributed, so every loader falls back
to a deterministic synthetic image of the right modality and size; img 9 is
the real MRI slice vendored at data/real/s1045.ima.gz. All loaders return
float32 (C, H, W) arrays in [0, 1] (the inpainting mask too), bit-equal to
the JAX package's.
"""

from __future__ import annotations

import gzip
import os
import warnings

import numpy as np

_DEN_FILES = {
    0: ("denoising/BACTERIA-1351146-0006.png", (256, 256)),
    1: ("denoising/VIRUS-9815549-0001.png", (256, 256)),
    2: ("denoising/BACTERIA-84621-0001_res.png", (256, 256)),
    3: ("denoising/VIRUS-9815549-0001.png", (256, 256)),
    4: ("denoising/CNV-13823-2_res.png", (256, 256)),
    5: ("denoising/NORMAL-293382-0001_res.png", (256, 256)),
}

_SR_FILES = {
    0: "super-resolution/img_139_res384.png",
    1: "super-resolution/test_mri_1.png",
    2: "super-resolution/test_mri_2.png",
    3: "super-resolution/test_mri_3.png",
    4: "super-resolution/test_mri_4.png",
    5: "super-resolution/test_mri_5.png",
    6: "super-resolution/test_mri_6.png",
    7: "super-resolution/test_mri_7.png",
}

_INP_FILES = {i: (f"inpainting/hair_{i}_res.png",
                  f"inpainting/hair_{i}_res_mask.png") for i in range(6)}

_CT_FILES = {i: f"ct/coronacases_org_00{i}.npy" for i in range(1, 6)}

_REAL_MRI = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "data", "real", "s1045.ima.gz")


def data_root() -> str:
    return os.environ.get("MFVI_DIP_DATA", "./data")


def _exists(rel: str) -> bool:
    return os.path.isfile(os.path.join(data_root(), rel))


def _smooth(x: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(x, sigma)


def _norm01(x):
    x = x - x.min()
    m = x.max()
    return (x / m if m > 0 else x).astype(np.float32)


def synthetic_xray(img: int, size: int = 256) -> np.ndarray:
    """Chest-xray-like grayscale image: smooth blobs + rib-like ripples +
    vignette."""
    rng = np.random.default_rng(1000 + img)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = _smooth(rng.standard_normal((size, size)), size / 16)
    ribs = 0.15 * np.sin(
        yy * 40 + 3 * _smooth(rng.standard_normal((size, size)), size / 8))
    vign = 1.0 - 0.8 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
    return _norm01(_norm01(base) * 0.6 + ribs + 0.3 * vign)[None]


def synthetic_mri(img: int, size: int = 384) -> np.ndarray:
    """Brain-MRI-like grayscale image: skull ring + smooth internal
    structure."""
    rng = np.random.default_rng(2000 + img)
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = size / 2, size / 2
    r = np.hypot((yy - cy) / (0.45 * size), (xx - cx) / (0.38 * size))
    skull = np.exp(-((r - 0.95) ** 2) / 0.002)
    interior = (r < 0.9).astype(np.float32)
    tissue = _smooth(rng.standard_normal((size, size)), size / 24)
    folds = np.sin(12 * np.arctan2(yy - cy, xx - cx) + 20 * r)
    return _norm01(skull + interior * (0.45 + 0.3 * _norm01(tissue)
                                       + 0.08 * folds))[None]


def shepp_logan(size: int = 256) -> np.ndarray:
    """Classic Shepp-Logan head phantom (standard ellipse table)."""
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


def synthetic_ct(img: int, size: int = 256) -> np.ndarray:
    """Lung-CT-like slice: body ellipse with two low-density lung fields and
    vessel speckle."""
    rng = np.random.default_rng(3000 + img)
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = size / 2, size / 2
    body = (np.hypot((yy - cy) / (0.48 * size), (xx - cx) / (0.42 * size))
            < 1.0).astype(np.float32)
    out = 0.65 * body
    for sx in (-0.18, 0.18):
        lung = np.hypot((yy - cy * 1.02) / (0.3 * size),
                        (xx - cx - sx * size) / (0.16 * size)) < 1.0
        vessels = _norm01(_smooth(rng.standard_normal((size, size)),
                                  2.0)) * 0.25
        out = np.where(lung, 0.12 + vessels, out)
    spine = np.hypot((yy - 0.82 * size) / (0.06 * size),
                     (xx - cx) / (0.05 * size)) < 1.0
    out = np.where(spine, 0.95, out)
    return _smooth(out, 1.2).astype(np.float32)[None]


def synthetic_hair(img: int, size: int = 256):
    """RGB skin-like texture (3, size, size) and a thin-curve occlusion mask
    of the same shape (1 = known pixel), like the reference's dilated hair
    masks."""
    rng = np.random.default_rng(4000 + img)
    base = np.stack([
        _norm01(_smooth(rng.standard_normal((size, size)), size / 10)) * 0.25
        + c for c in (0.65, 0.45, 0.35)])
    base = np.clip(base, 0, 1).astype(np.float32)
    mask = np.ones((size, size), np.float32)
    for _ in range(12):
        x = rng.uniform(0, size)
        y = rng.uniform(0, size)
        ang = rng.uniform(0, np.pi)
        curv = rng.uniform(-0.02, 0.02)
        for _ in range(2 * size):
            xi, yi = int(x) % size, int(y) % size
            mask[max(yi - 1, 0):yi + 2, max(xi - 1, 0):xi + 2] = 0.0
            ang += curv
            x += np.cos(ang)
            y += np.sin(ang)
    return base, np.repeat(mask[None], 3, axis=0)


def real_mri_slice() -> np.ndarray:
    """(1, 256, 256) float32 in [0, 1]: the vendored real MRI head slice
    (uint16 raw, gzip); img index 9 of the ct and denoising tasks."""
    with gzip.open(_REAL_MRI) as f:
        raw = f.read()
    im = np.frombuffer(raw, np.uint16).astype(np.float32).reshape(256, 256)
    return _norm01(im)[None]


def _warn_fallback(task, img, rel):
    warnings.warn(
        f"{task} image {img}: '{rel}' not found under {data_root()!r}; "
        "using a deterministic synthetic fallback")


def _load_image(path: str, imsize=(-1, -1)) -> np.ndarray:
    """PIL load + resize to ``imsize`` (-1: as stored) -> float32 (C, H, W)
    in [0, 1]."""
    from PIL import Image
    img = Image.open(path)
    if imsize[0] != -1 and img.size != imsize:
        img = img.resize(imsize, Image.BICUBIC if imsize[0] > img.size[0]
                         else Image.LANCZOS)
    ar = np.array(img)
    ar = ar.transpose(2, 0, 1) if ar.ndim == 3 else ar[None]
    return ar.astype(np.float32) / 255.0


def _crop_np(img_np: np.ndarray, d: int = 32) -> np.ndarray:
    _, h, w = img_np.shape
    nh, nw = h - h % d, w - w % d
    top, left = (h - nh) // 2, (w - nw) // 2
    return img_np[:, top:top + nh, left:left + nw]


def get_image_denoising(img: int):
    """-> (img_np CHW, imsize); img 9 is the vendored real MRI slice."""
    if img == 9:
        im = real_mri_slice()
        return im, im.shape[1:]
    rel, imsize = _DEN_FILES[img]
    if _exists(rel):
        img_np = _crop_np(_load_image(os.path.join(data_root(), rel),
                                      imsize), 32)
    else:
        _warn_fallback("denoising", img, rel)
        img_np = synthetic_xray(img, imsize[0])
    return img_np, imsize


def get_img_superresolution(img: int):
    """-> (img_np CHW, imsize): the high-resolution image (384^2 synthetic
    MRI as the fallback); img 9 is the vendored real MRI slice."""
    if img == 9:
        im = real_mri_slice()
        return im, im.shape[1:]
    rel = _SR_FILES[img]
    if _exists(rel):
        img_np = _load_image(os.path.join(data_root(), rel))
    else:
        _warn_fallback("super-resolution", img, rel)
        img_np = synthetic_mri(img, 384)
    return img_np, img_np.shape[1:]


def get_img_inpainting(img: int):
    """-> (img_np CHW, mask_np CHW, imsize): an RGB image and its mask
    (256^2 synthetic skin and hair curves as the fallback); img 9 is the
    real MRI slice repeated to 3 channels under img 0's hair mask."""
    if img == 9:
        im = np.repeat(real_mri_slice(), 3, axis=0)
        _, mask = synthetic_hair(0, im.shape[1])
        return im, mask, im.shape[1:]
    rel, mask_rel = _INP_FILES[img]
    if _exists(rel) and _exists(mask_rel):
        img_np = _load_image(os.path.join(data_root(), rel))
        mask_np = _load_image(os.path.join(data_root(), mask_rel))
    else:
        _warn_fallback("inpainting", img, rel)
        img_np, mask_np = synthetic_hair(img, 256)
    return img_np, mask_np, img_np.shape[1:]


def get_img_ct(img: int):
    """-> (img_np CHW, imsize); img 0 is skimage's brain slice where
    scikit-image is installed, else the Shepp-Logan phantom."""
    if img == 9:
        im = real_mri_slice()
        return im, im.shape[1:]
    if img == 0:
        try:
            from skimage.data import brain
            img_np = (brain()[4][None] / (2 ** 16)).astype(np.float32)
        except ImportError:
            _warn_fallback("ct", img, "skimage.data.brain")
            img_np = shepp_logan(256)
    else:
        rel = _CT_FILES[img]
        if _exists(rel):
            raw = np.load(os.path.join(data_root(), rel)).astype(np.float32)
            from scipy.ndimage import zoom, gaussian_filter
            raw = gaussian_filter(raw, 1.0 / 3.0)
            img_np = zoom(raw, 0.5, order=1)[None]
        else:
            _warn_fallback("ct", img, rel)
            img_np = synthetic_ct(img, 256)
    return img_np, img_np.shape[1:]
