"""Host-side image utilities (counterpart of mfvi_dip_mia_tpu/utils/images.py).

Host numpy, bit-equal to the JAX package: images are float32 (C, H, W) in
[0, 1]; the DIP input noise is drawn in NHWC order from a numpy Generator so
both packages see the same values for the same seed.
"""

from __future__ import annotations

import numpy as np


def chw_to_nhwc(img_np: np.ndarray) -> np.ndarray:
    """(C, H, W) -> (1, H, W, C)."""
    return np.ascontiguousarray(img_np.transpose(1, 2, 0))[None]


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
