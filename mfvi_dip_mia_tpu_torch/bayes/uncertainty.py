"""Predictive uncertainty from MC posterior samples (counterpart of
mfvi_dip_mia_tpu/bayes/uncertainty.py): ``mc_predict`` and Gal's regression
decomposition, epistemic = Var_samples[mu], aleatoric =
E_samples[exp(-neg_logvar)]. NCHW: the channel axis is 2 of (S, N, C, H, W).
"""

from __future__ import annotations

import torch

from ..nn.var_conv import REPARAMS
from . import vi


def mc_predict(apply_fn, params: vi.FlatParams, x: torch.Tensor,
               generator: torch.Generator, n_samples: int,
               reparam: str = "rt") -> torch.Tensor:
    """``n_samples`` stochastic forwards in a loop under no_grad, as
    uncertainty.py:41-50 draws them: under ``reparam='rt'`` each on one
    whole-tree RT draw (vi.sample_mfvi_tree), ``apply_fn(leaves, x)``; under
    'lrt' each on the unsampled mu / rho tree with fresh activation noise,
    ``apply_fn(leaves, x, generator, reparam='lrt')``. apply_fn returns
    (N, C, H, W); the result is (S, N, C, H, W). JAX maps the samples
    through one compiled graph; eager PyTorch runs them one after another."""
    if reparam not in REPARAMS:
        raise ValueError(f"unknown reparam {reparam!r}")

    def one():
        if reparam == "lrt":
            return apply_fn(params.leaves(), x, generator, reparam="lrt")
        return apply_fn(vi.sample_mfvi_tree(params, generator), x)

    with torch.no_grad():
        return torch.stack([one() for _ in range(n_samples)])


def uncert_regression_gal(outputs: torch.Tensor, mean_channels: int = 1):
    """Stacked MC outputs (S, N, C, H, W) -> (mean, aleatoric, epistemic),
    each (N, mean_channels, H, W). Channels [0:mean_channels] are mu, the
    rest neg_logvar; the variance is the biased one (jnp.var)."""
    mu = outputs[:, :, :mean_channels]
    mean = mu.mean(dim=0)
    epistemic = mu.var(dim=0, unbiased=False)
    if outputs.shape[2] > mean_channels:
        aleatoric = torch.exp(-outputs[:, :, mean_channels:]).mean(dim=0)
    else:
        aleatoric = torch.zeros_like(epistemic)
    return mean, aleatoric, epistemic
