"""Acquisition functions and the candidate search (counterpart of
mfvi_dip_mia_tpu/bo/acquisition.py), in float64 on the host CPU as the GP is
(bo/gp.py).

  * EI (maximization form, no xi): imp = mu - max(mu(X_train));
    ei = sigma * (pdf(u) + u * cdf(u)), clamped at 0
  * UCB with kappa = 2
  * find_candidates: the acquisition on the 100x100 normalized grid ->
    local peaks (min_distance=5, threshold_rel=0.1, up to 4) plus the global
    maximum -> each refined by L-BFGS-B on sigmoid-unconstrained
    coordinates (scipy, with the float64 gradient from torch.autograd) ->
    up to 4 candidates, deduplicated after the refinement.

``peak_local_max`` is skimage.feature.peak_local_max's behaviour for this
use, on scipy.ndimage.maximum_filter (a copy of the JAX package's).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage
from scipy.optimize import minimize

from .gp import as_f64

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def expected_improvement(gp, x_query, x_train):
    mu, var = gp.predict(x_query)
    sigma = torch.sqrt(torch.clamp(var, min=1e-9))
    mu_train, _ = gp.predict(x_train)
    imp = mu - torch.max(mu_train)
    u = imp / sigma
    ucdf = torch.special.ndtr(u)
    updf = torch.exp(-0.5 * u * u) * _INV_SQRT_2PI
    ei = sigma * (updf + u * ucdf)
    return torch.clamp(ei, min=0.0)


def upper_confidence_bound(gp, x_query, kappa: float = 2.0):
    mu, var = gp.predict(x_query)
    return mu + kappa * torch.sqrt(var)


def acquisition_fun(gp, x_query, x_train, acq_fn: str = "ei", *args):
    if acq_fn == "ei":
        return expected_improvement(gp, x_query, x_train)
    if acq_fn == "ucb":
        return upper_confidence_bound(gp, x_query, *args)
    raise ValueError(acq_fn)


def peak_local_max(image: np.ndarray, min_distance: int = 5,
                   threshold_rel: float = 0.1, num_peaks: int = 4
                   ) -> np.ndarray:
    """skimage.feature.peak_local_max-compatible local maxima (indices sorted
    by descending intensity), with min_distance border exclusion."""
    size = 2 * min_distance + 1
    maxf = ndimage.maximum_filter(image, size=size, mode="constant",
                                  cval=-np.inf)
    thresh = threshold_rel * image.max()
    mask = (image == maxf) & (image > thresh)
    if min_distance > 0:
        border = np.zeros_like(mask)
        border[min_distance:-min_distance, min_distance:-min_distance] = True
        mask &= border
    coords = np.argwhere(mask)
    if len(coords) == 0:
        return coords.reshape(0, 2)
    order = np.argsort(image[tuple(coords.T)])[::-1]
    return coords[order][:num_peaks]


def find_candidates(gp, x_grid, x_train, acq_fn: str = "ei",
                    grid_shape=(100, 100), max_candidates: int = 4):
    """Grid acquisition -> peaks -> L-BFGS-B refinement.

    Returns (candidates [k, 2] in [0,1]^2 normalized space,
             expected improvements [k] (a list, aligned with the candidates),
             the acquisition surface flattened, numpy)."""
    x_train64 = as_f64(x_train)
    with torch.no_grad():
        acq = acquisition_fun(gp, as_f64(x_grid), x_train64, acq_fn).numpy()

    acq_img = acq.reshape(grid_shape)
    peaks = peak_local_max(acq_img, min_distance=5, threshold_rel=0.1,
                           num_peaks=4)
    gmax = np.array(np.unravel_index(np.argmax(acq_img), grid_shape)
                    ).reshape(1, -1)
    peaks = np.unique(np.append(peaks, gmax, axis=0), axis=0)
    flat_idx = np.ravel_multi_index(peaks.T, grid_shape)
    x_init = np.asarray(x_grid)[flat_idx]

    def f(u):
        u = torch.tensor(u, dtype=torch.float64, requires_grad=True)
        v = -acquisition_fun(gp, torch.sigmoid(u).reshape(1, -1), x_train64,
                             acq_fn)[0]
        v.backward()
        return float(v.detach()), u.grad.numpy()

    candidates, eis = [], []
    for xi in x_init[:max_candidates]:
        xi = np.clip(xi, 1e-6, 1 - 1e-6)
        u0 = np.log(xi / (1.0 - xi))  # sigmoid^-1
        res = minimize(f, u0, jac=True, method="L-BFGS-B")
        x_star = 1.0 / (1.0 + np.exp(-res.x))
        with torch.no_grad():
            ei = float(acquisition_fun(gp, x_star.reshape(1, -1), x_train64,
                                       acq_fn)[0])
        candidates.append(x_star)
        eis.append(ei)

    # Post-refinement dedup: peaks that L-BFGS takes to one optimum are
    # evaluated once. np.unique sorts and drops rows, so the EIs are
    # re-indexed to stay aligned with their candidates.
    candidates, keep = np.unique(np.stack(candidates), axis=0,
                                 return_index=True)
    eis = [eis[i] for i in keep]
    return candidates, eis, acq
