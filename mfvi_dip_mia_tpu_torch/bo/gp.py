"""The exact Gaussian process of the BO loop, in float64 on the host CPU
(counterpart of mfvi_dip_mia_tpu/bo/gp.py, term for term).

Model (the reference's ExactGPModel + GaussianLikelihood):
  * mean: a learned constant with a Normal(15, 4) prior
  * kernel: outputscale * RBF(lengthscale), lengthscale initialised at 0.3,
    raw parameters through softplus
  * noise: 1e-4 + softplus(raw) with a Gamma(0.01, 100) prior
  * loss: -(log marginal likelihood + the priors' log-probabilities) / n,
    minimised by Adam(lr=0.05) for 2000 iterations

The GP stays on the host CPU by design, as the JAX package pins it there
(``host_cpu`` / ``_on_host``): it is a problem of at most ~100 observations
in float64, thousands of tiny eager operations that a card would only
dispatch slowly, and the card's float64 rate buys nothing at that size. So
every tensor here is a CPU float64 tensor, whatever card the fits ran on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)
JITTER = 1e-8
DTYPE = torch.float64
_CPU = torch.device("cpu")


class GPParams(NamedTuple):
    raw_lengthscale: torch.Tensor
    raw_outputscale: torch.Tensor
    raw_noise: torch.Tensor
    mean_const: torch.Tensor


def as_f64(a) -> torch.Tensor:
    """numpy / a tensor -> a float64 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(_CPU, DTYPE)
    return torch.tensor(np.asarray(a, np.float64))


def _softplus(x):
    # logaddexp(x, 0) as jnp does: F.softplus switches to x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    return float(np.log(np.expm1(y)))


def lengthscale(p: GPParams):
    return _softplus(p.raw_lengthscale)


def outputscale(p: GPParams):
    return _softplus(p.raw_outputscale)


def noise(p: GPParams):
    return 1e-4 + _softplus(p.raw_noise)


def _rbf(x1, x2, ls):
    d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
    return torch.exp(-0.5 * d2 / (ls ** 2))


def _kernel(p: GPParams, x1, x2):
    return outputscale(p) * _rbf(x1, x2, lengthscale(p))


def _chol_alpha(p: GPParams, x, y):
    n = x.shape[0]
    k = _kernel(p, x, x) + (noise(p) + JITTER) * torch.eye(n, dtype=DTYPE)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve((y - p.mean_const)[:, None], chol)[:, 0]
    return chol, alpha


def _neg_mll(p: GPParams, x, y):
    if x.dtype != DTYPE or y.dtype != DTYPE:
        raise TypeError(f"the GP runs in float64, got {x.dtype}/{y.dtype}")
    n = x.shape[0]
    chol, alpha = _chol_alpha(p, x, y)
    resid = y - p.mean_const
    mll = (-0.5 * resid @ alpha
           - torch.sum(torch.log(torch.diagonal(chol)))
           - 0.5 * n * _LOG_2PI)
    # the priors' log-probabilities join the MLL before the division by n
    mean_prior = (-0.5 * ((p.mean_const - 15.0) / 4.0) ** 2
                  - math.log(4.0) - 0.5 * _LOG_2PI)
    # Gamma(concentration=0.01, rate=100): a*log(b) - lgamma(a)
    #   + (a-1)*log(x) - b*x
    nz = noise(p)
    noise_prior = (0.01 * math.log(100.0) - math.lgamma(0.01)
                   + (0.01 - 1.0) * torch.log(nz) - 100.0 * nz)
    return -(mll + mean_prior + noise_prior) / n


@dataclasses.dataclass
class ExactGP:
    """A fitted GP: posterior mean and latent variance at query points."""
    params: GPParams
    x_train: torch.Tensor
    y_train: torch.Tensor
    chol: torch.Tensor
    alpha: torch.Tensor

    @classmethod
    def fitted(cls, params: GPParams, x_train, y_train) -> "ExactGP":
        """The posterior of hyperparameters ``params`` on (x, y)."""
        x, y = as_f64(x_train), as_f64(y_train)
        p = GPParams(*(as_f64(v) for v in params))
        with torch.no_grad():
            chol, alpha = _chol_alpha(p, x, y)
        return cls(params=p, x_train=x, y_train=y, chol=chol, alpha=alpha)

    def predict(self, x_query):
        """Latent-f posterior (no observation noise) at ``x_query`` (numpy
        or a tensor, cast to float64): (mean, variance clamped at 0).
        Differentiable in ``x_query``."""
        xq = (x_query.to(DTYPE) if isinstance(x_query, torch.Tensor)
              else as_f64(x_query))
        p = self.params
        k_star = _kernel(p, xq, self.x_train)
        mean = p.mean_const + k_star @ self.alpha
        v = torch.linalg.solve_triangular(self.chol, k_star.T, upper=False)
        var = outputscale(p) - torch.sum(v * v, dim=0)
        return mean, torch.clamp(var, min=0.0)

    @property
    def hyperparams(self):
        p = self.params
        return {"lengthscale": float(lengthscale(p)),
                "outputscale": float(outputscale(p)),
                "noise": float(noise(p)),
                "mean": float(p.mean_const)}


def train_gp(x_train, y_train, iter_max: int = 2000, lr: float = 0.05,
             verbose: bool = False) -> ExactGP:
    """Fit the hyperparameters by Adam on the exact MLL (the reference's
    recipe). ``torch.optim.Adam``'s defaults (betas 0.9 / 0.999, eps 1e-8)
    are ``optax.adam``'s."""
    x, y = as_f64(x_train), as_f64(y_train)
    leaves = [torch.tensor(v, dtype=DTYPE, requires_grad=True)
              for v in (_inv_softplus(0.3), 0.0, 0.0, 0.0)]
    p = GPParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=lr)
    for i in range(iter_max):
        opt.zero_grad()
        loss = _neg_mll(p, x, y)
        loss.backward()
        opt.step()
        if verbose and i % 100 == 0:
            with torch.no_grad():
                print(f"GP iter {i + 1:4d}/{iter_max} - "
                      f"loss {float(loss):.4f} "
                      f"lengthscale {float(lengthscale(p)):.3f} "
                      f"noise {float(noise(p)):.4f}")
    return ExactGP.fitted(GPParams(*(t.detach() for t in leaves)), x, y)
