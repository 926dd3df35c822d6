"""Weight priors: Normal and scale-mixture Normal, with the MC KL
(counterpart of mfvi_dip_mia_tpu/bayes/priors.py). The closed-form
Normal-Normal KL lives in bayes/vi.py; the mixture has no closed form, so
the KL is a one-sample-per-default MC estimate, drawn from an explicit
``torch.Generator``. A mixture draws its components through
``vi.mixture_draw``."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import vi

normal_log_prob = vi.normal_lp


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class NormalPrior:
    loc: float = 0.0
    scale: float = 0.1

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return normal_log_prob(x, _f32(self.loc, x.device),
                               _f32(self.scale, x.device))

    def sample(self, generator: torch.Generator, shape) -> torch.Tensor:
        return self.loc + self.scale * torch.randn(
            tuple(shape), generator=generator, device=generator.device)


@dataclasses.dataclass(frozen=True)
class MixtureNormalPrior:
    """Scale mixture of Normals (Blundell et al.); pi are mixture weights."""
    loc: tuple
    scale: tuple
    pi: tuple

    def mixture(self, device=None) -> vi.Mixture:
        return vi.Mixture.of(self.loc, self.scale, self.pi, device)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        pdf = torch.zeros_like(x)
        for loc, scale, pi in zip(self.loc, self.scale, self.pi):
            pdf = pdf + pi * torch.exp(normal_log_prob(
                x, _f32(loc, x.device), _f32(scale, x.device)))
        return torch.log(pdf)

    def sample(self, generator: torch.Generator, shape) -> torch.Tensor:
        mix = self.mixture(generator.device)
        comp, z = vi.mixture_draw(math.prod(shape), mix.cum, generator)
        return (mix.loc[comp] + mix.scale[comp] * z).reshape(tuple(shape))


def mc_kl_divergence(generator: torch.Generator, p, q, shape,
                     n_samples: int = 1) -> torch.Tensor:
    """MC estimate of KL(p || q), elementwise over ``shape``: the mean over
    ``n_samples`` draws from ``p`` of log p - log q."""
    total = 0.0
    for _ in range(n_samples):
        s = p.sample(generator, shape)
        total = total + (p.log_prob(s) - q.log_prob(s))
    return total / n_samples


def make_prior(spec: dict):
    """A prior from the reference's dict schema ({'mu', 'sigma'} or {'mu',
    'sigma', 'pi'}); sigma gets the +1e-6 stabilizer."""
    if "pi" in spec:
        sigma = tuple(s + vi.PRIOR_SIGMA_STABILIZER for s in spec["sigma"])
        return MixtureNormalPrior(tuple(spec["mu"]), sigma, tuple(spec["pi"]))
    return NormalPrior(spec["mu"], spec["sigma"] + vi.PRIOR_SIGMA_STABILIZER)
