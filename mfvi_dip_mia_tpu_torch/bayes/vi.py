"""Mean-field VI on a flat parameter buffer (counterpart of
mfvi_dip_mia_tpu/bayes/vi.py).

``to_mfvi`` turns every conv leaf ``{'w', 'b'}`` of a parameter dict into
``{'w_mu', 'w_rho', 'b_mu', 'b_rho'}`` (mu ~ N(0, 0.1), rho ~ N(-3, 0.1)).
``flatten`` lays the dict out as ONE buffer of three segments
``[mu | rho | det]`` (optim/fused_adamw.py's layout): the mu and rho segments
align elementwise, so the whole-tree RT draw is one elementwise pass, the KL
one reduction, and the AdamW step one pass over the buffer, while every leaf
stays a view of it for the network.

KL semantics: KL(prior || posterior) in closed form summed over all weight
and bias elements, with the reference's +1e-6 prior-scale stabilizer, which
dominates at POTOBIM's temperatures (sqrt(temp) * sigma ~ 1e-12).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..nn import init as init_lib

PRIOR_SIGMA_STABILIZER = 1e-6


def to_mfvi(params: dict, generator: torch.Generator,
            posterior_mu_init=(0.0, 0.1),
            posterior_rho_init=(-3.0, 0.1)) -> dict:
    """Replace every conv leaf with re-initialized (mu, rho) parameters."""
    out = {}
    for name, t in params.items():
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("w", "b") and f"{prefix}.w" in params:
            out[f"{prefix}.{leaf}_mu"] = init_lib.normal(
                generator, t.shape, *posterior_mu_init)
            out[f"{prefix}.{leaf}_rho"] = init_lib.normal(
                generator, t.shape, *posterior_rho_init)
        else:
            out[name] = t
    return out


@dataclasses.dataclass
class FlatParams:
    """A parameter dict laid out as one buffer ``[mu | rho | det]``.

    ``names``/``shapes``/``offsets`` describe every leaf in buffer order;
    ``n_var`` is the length of the mu segment (= the rho segment)."""
    flat: torch.Tensor
    names: list
    shapes: list
    offsets: list
    n_var: int

    def with_flat(self, flat: torch.Tensor) -> "FlatParams":
        return dataclasses.replace(self, flat=flat)

    def leaves(self) -> dict:
        """name -> view of the buffer."""
        return {n: self.flat[o:o + math.prod(s)].view(s)
                for n, s, o in zip(self.names, self.shapes, self.offsets)}

    @property
    def mu(self) -> torch.Tensor:
        return self.flat[:self.n_var]

    @property
    def rho(self) -> torch.Tensor:
        return self.flat[self.n_var:2 * self.n_var]


def flatten(params: dict, device=None) -> FlatParams:
    """Lay ``params`` out as [mu | rho | det] (leaf order within a segment is
    the dict's) on ``device``, by default the leaves' own. Every '*_mu' leaf
    must have its '*_rho' twin."""
    mu = [n for n in params if n.endswith("_mu")]
    rho = [n[:-3] + "_rho" for n in mu]
    missing = [n for n in rho if n not in params]
    if missing or len(rho) != sum(n.endswith("_rho") for n in params):
        raise ValueError(f"unpaired variational leaves: {missing}")
    det = [n for n in params if not n.endswith(("_mu", "_rho"))]
    names = mu + rho + det
    shapes = [tuple(params[n].shape) for n in names]
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += math.prod(s)
    flat = torch.cat([params[n].reshape(-1).float() for n in names]) if names \
        else torch.zeros(0)
    n_var = sum(math.prod(params[n].shape) for n in mu)
    return FlatParams(flat if device is None else flat.to(device), names,
                      shapes, offsets, n_var)


def eps_order(params: FlatParams) -> list:
    """(sampled-leaf name, shape) in the order ``sample_mfvi_tree`` consumes
    its eps vector: the mu segment's leaves with '_mu' dropped."""
    return [(n[:-3], s) for n, s in zip(params.names, params.shapes)
            if n.endswith("_mu")]


def sample_mfvi_tree(params: FlatParams, generator=None, out_dtype=None,
                     eps: torch.Tensor | None = None) -> dict:
    """One RT draw for the whole tree: mu + softplus(rho) * eps over the flat
    segments in one pass (cast once to ``out_dtype``), returned as a dict of
    deterministic leaves ('<path>.w', '<path>.b') plus the det leaves as
    views of the buffer. ``eps`` (length n_var, in ``eps_order``) replaces
    the standard-normal draw from ``generator``."""
    n = params.n_var
    if eps is None:
        eps = torch.randn((n,), generator=generator, device=params.flat.device)
    sample = params.mu + F.softplus(params.rho) * eps
    if out_dtype is not None:
        sample = sample.to(out_dtype)
    out = {}
    for name, s, o in zip(params.names, params.shapes, params.offsets):
        size = math.prod(s)
        if name.endswith("_mu"):
            out[name[:-3]] = sample[o:o + size].view(s)
        elif o >= 2 * n:
            out[name] = params.flat[o:o + size].view(s)
    return out


def kl_mfvi(params: FlatParams, prior_mu: float = 0.0,
            prior_sigma: float = 0.1) -> torch.Tensor:
    """Sum of the elementwise reverse KL(N(prior_mu, sigma_p) ||
    N(mu, softplus(rho))), sigma_p = prior_sigma + 1e-6."""
    if params.n_var == 0:
        return torch.zeros((), device=params.flat.device)
    sigma_p = prior_sigma + PRIOR_SIGMA_STABILIZER
    sigma_q = F.softplus(params.rho)
    kl = (torch.log(sigma_q) - math.log(sigma_p)
          + (sigma_p ** 2 + (prior_mu - params.mu) ** 2) / (2.0 * sigma_q ** 2)
          - 0.5)
    return kl.sum()
