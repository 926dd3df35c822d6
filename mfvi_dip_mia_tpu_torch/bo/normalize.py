"""log10-space min-max normalization of the 2-D BO parameter space
(counterpart of mfvi_dip_mia_tpu/bo/normalize.py; numpy only)."""

from __future__ import annotations

import numpy as np


def normalize_X(x_unnorm: np.ndarray, x1_logbounds, x2_logbounds) -> np.ndarray:
    x = np.log10(np.asarray(x_unnorm, np.float64)).copy()
    x[:, 0] = (x[:, 0] - x1_logbounds[0]) / (x1_logbounds[1] - x1_logbounds[0])
    x[:, 1] = (x[:, 1] - x2_logbounds[0]) / (x2_logbounds[1] - x2_logbounds[0])
    return x


def unnormalize_X(x_norm: np.ndarray, x1_logbounds, x2_logbounds) -> np.ndarray:
    x = np.asarray(x_norm, np.float64).copy()
    x[:, 0] = x[:, 0] * (x1_logbounds[1] - x1_logbounds[0]) + x1_logbounds[0]
    x[:, 1] = x[:, 1] * (x2_logbounds[1] - x2_logbounds[0]) + x2_logbounds[0]
    return np.power(10.0, x)
