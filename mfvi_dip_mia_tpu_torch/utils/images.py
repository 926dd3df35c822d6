"""Host-side image utilities (counterpart of mfvi_dip_mia_tpu/utils/images.py).

Host numpy, bit-equal to the JAX package: images are float32 (C, H, W) in
[0, 1]; the DIP input noise is drawn in NHWC order from a numpy Generator so
both packages see the same values for the same seed. The PIL helpers
(conversion, cropping, loading, the sr pair and baselines) import PIL when
called and raise RuntimeError("PIL not available") without it; nothing on
the card's path calls them.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("PIL not available") from None
    return Image


# -- numpy <-> PIL <-> device layout --------------------------------------------

def pil_to_np(img_pil) -> np.ndarray:
    """PIL image -> float32 (C, H, W) in [0, 1]."""
    ar = np.array(img_pil)
    ar = ar.transpose(2, 0, 1) if ar.ndim == 3 else ar[None, ...]
    return ar.astype(np.float32) / 255.0


def np_to_pil(img_np: np.ndarray):
    """float32 (C, H, W) in [0, 1] -> PIL image."""
    Image = _pil()
    ar = np.clip(img_np * 255, 0, 255).astype(np.uint8)
    ar = ar[0] if img_np.shape[0] == 1 else ar.transpose(1, 2, 0)
    return Image.fromarray(ar)


def chw_to_nhwc(img_np: np.ndarray) -> np.ndarray:
    """(C, H, W) -> (1, H, W, C)."""
    return np.ascontiguousarray(img_np.transpose(1, 2, 0))[None]


def nhwc_to_chw(x: np.ndarray) -> np.ndarray:
    """(1, H, W, C) -> (C, H, W)."""
    return np.asarray(x)[0].transpose(2, 0, 1)


# -- cropping / loading ------------------------------------------------------------

def crop_image(img_pil, d: int = 32):
    """Center-crop a PIL image so that its sides divide by ``d``."""
    w, h = img_pil.size
    new_w, new_h = w - w % d, h - h % d
    return img_pil.crop((int((w - new_w) / 2), int((h - new_h) / 2),
                         int((w + new_w) / 2), int((h + new_h) / 2)))


def crop_np(img_np: np.ndarray, d: int = 32) -> np.ndarray:
    """Center-crop a (C, H, W) array so that H and W divide by ``d``."""
    _, h, w = img_np.shape
    nh, nw = h - h % d, w - w % d
    top, left = (h - nh) // 2, (w - nw) // 2
    return img_np[:, top:top + nh, left:left + nw]


def load_image(path: str, imsize=-1) -> np.ndarray:
    """An image file as float32 (C, H, W) in [0, 1], resized to ``imsize``
    (an int or (w, h); -1 keeps the size): bicubic up, Lanczos down."""
    Image = _pil()
    img = Image.open(path)
    if isinstance(imsize, int):
        imsize = (imsize, imsize)
    if imsize[0] != -1 and img.size != imsize:
        img = img.resize(imsize, Image.BICUBIC if imsize[0] > img.size[0]
                         else Image.LANCZOS)
    return pil_to_np(img)


def get_noise(input_depth: int, spatial_size, noise_type: str = "u",
              var: float = 0.1, rng: np.random.Generator | None = None
              ) -> np.ndarray:
    """Random DIP input of shape (1, H, W, input_depth), scaled by ``var``
    (uniform[0, 1] * 0.1 by default)."""
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    rng = rng or np.random.default_rng()
    shape = (1, spatial_size[0], spatial_size[1], input_depth)
    if noise_type == "u":
        x = rng.random(shape, dtype=np.float32)
    elif noise_type == "n":
        x = rng.standard_normal(shape, dtype=np.float32)
    else:
        raise ValueError(f"unknown noise_type {noise_type!r}")
    return x * var


def add_gaussian_noise(img_np: np.ndarray, sigma: float,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Gaussian corruption clipped to [0, 1]."""
    rng = rng or np.random.default_rng()
    noisy = img_np + rng.normal(scale=sigma, size=img_np.shape)
    return np.clip(noisy, 0, 1).astype(np.float32)


def get_meshgrid(spatial_size) -> np.ndarray:
    """The meshgrid input (1, H, W, 2), x then y, each in [0, 1]."""
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    X, Y = np.meshgrid(
        np.arange(0, spatial_size[1]) / float(spatial_size[1] - 1),
        np.arange(0, spatial_size[0]) / float(spatial_size[0] - 1))
    return np.stack([X, Y], axis=-1).astype(np.float32)[None]


def add_poisson_noise(img_np: np.ndarray, lam: float,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """Poisson corruption clipped to [0, 1]: img + Poisson(lam) / 255."""
    rng = rng or np.random.default_rng()
    noisy = img_np + rng.poisson(lam=lam, size=img_np.shape) / 255.0
    return np.clip(noisy, 0, 1).astype(np.float32)


def put_in_center(img_np: np.ndarray, target_size) -> np.ndarray:
    """Zero-pad a (C, H, W) image into the center of ``target_size``."""
    out = np.zeros((img_np.shape[0], target_size[0], target_size[1]),
                   np.float32)
    top = (target_size[0] - img_np.shape[1]) // 2
    left = (target_size[1] - img_np.shape[2]) // 2
    out[:, top:top + img_np.shape[1], left:left + img_np.shape[2]] = img_np
    return out


def load_lr_hr_imgs_sr(fname: str, imsize=-1, factor: int = 4,
                       enforce_div32: str | None = None) -> dict:
    """An HR image and its Lanczos-downscaled LR version (images.py:165):
    {'orig_np', 'HR_np', 'LR_np'}; ``enforce_div32='CROP'`` crops the HR
    image to sides that divide by 32 first."""
    Image = _pil()
    orig_np = load_image(fname, imsize)
    hr = crop_np(orig_np, 32) if enforce_div32 == "CROP" else orig_np
    lr_pil = np_to_pil(hr).resize((hr.shape[2] // factor,
                                   hr.shape[1] // factor), Image.LANCZOS)
    return {"orig_np": orig_np, "HR_np": hr, "LR_np": pil_to_np(lr_pil)}


def sr_baselines(lr_np: np.ndarray, hr_shape) -> dict:
    """Bicubic, sharpened bicubic and nearest upscalings of ``lr_np`` to
    the (C, H, W) ``hr_shape`` (images.py:181)."""
    Image = _pil()
    from PIL import ImageFilter
    lr_pil = np_to_pil(lr_np)
    size = (hr_shape[2], hr_shape[1])
    bic = lr_pil.resize(size, Image.BICUBIC)
    near = lr_pil.resize(size, Image.NEAREST)
    sharp = bic.filter(ImageFilter.UnsharpMask())
    return {"bicubic": pil_to_np(bic), "bicubic_sharp": pil_to_np(sharp),
            "nearest": pil_to_np(near)}


def normalize01(x: np.ndarray) -> np.ndarray:
    """Min-max normalization to [0, 1] (a constant image becomes 0)."""
    x = x - x.min()
    m = x.max()
    return x / m if m > 0 else x
