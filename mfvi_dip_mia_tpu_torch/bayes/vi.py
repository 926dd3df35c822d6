"""Mean-field VI on a flat parameter buffer (counterpart of
mfvi_dip_mia_tpu/bayes/vi.py).

``to_mfvi`` turns every conv leaf ``{'w', 'b'}`` of a parameter dict into
``{'w_mu', 'w_rho', 'b_mu', 'b_rho'}`` (mu ~ N(0, 0.1), rho ~ N(-3, 0.1)).
``flatten`` lays the dict out as ONE buffer of three segments
``[mu | rho | det]`` (optim/fused_adamw.py's layout): the mu and rho segments
align elementwise, so the whole-tree RT draw is one elementwise pass, the KL
one reduction, and the AdamW step one pass over the buffer, while every leaf
stays a view of it for the network.

KL semantics: KL(prior || posterior) ('reverse', the reference default) or
KL(posterior || prior) ('forward') in closed form summed over all weight and
bias elements, with the reference's +1e-6 prior-scale stabilizer, which
dominates at POTOBIM's temperatures (sqrt(temp) * sigma ~ 1e-12). A
scale-mixture prior has no closed form: ``kl_mfvi_mc`` estimates it with one
draw per element (vi.py:198-249), its draw ``mixture_draw`` an inverse CDF
on uniforms, so it runs inside a captured step.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import NamedTuple

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


class _Layout(NamedTuple):
    """The leaves ``sample_mfvi_tree`` returns, in its order: the sampled
    leaves (the mu segment's, '_mu' dropped) and then the det leaves, each
    (name, shape, offset into the buffer, size)."""
    sampled: tuple
    det: tuple


def _layout(params: FlatParams) -> _Layout:
    sampled, det = [], []
    for name, s, o in zip(params.names, params.shapes, params.offsets):
        if name.endswith("_mu"):
            sampled.append((name[:-3], s, o, math.prod(s)))
        elif o >= 2 * params.n_var:
            det.append((name, s, o, math.prod(s)))
    return _Layout(tuple(sampled), tuple(det))


_GATHERED_LOCK = threading.Lock()
_gathered = 0   # leaf gradients _Draw's backwards have gathered, all threads


def flat_grad_leaves() -> int:
    """The leaf gradients the draw's backward (``_Draw``) has gathered into
    flat gradients in this process so far, over every thread: each
    backward adds one per leaf it returned, a leaf with no gradient (its
    segment zeros) included."""
    with _GATHERED_LOCK:
        return _gathered


def _count_gathered(n: int) -> None:
    global _gathered
    with _GATHERED_LOCK:
        _gathered += n


def _flat_grads(grads, leaves, like: torch.Tensor) -> list:
    """Each leaf's gradient as a flat tensor; the leaves with none share
    one buffer of zeros (``like``'s dtype and device)."""
    sizes = [size for _, _, _, size in leaves]
    missing = [n for g, n in zip(grads, sizes) if g is None]
    zeros = like.new_zeros(max(missing)) if missing else None
    return [zeros[:n] if g is None else g.reshape(-1)
            for g, n in zip(grads, sizes)]


class _Draw(torch.autograd.Function):
    """The RT draw as one autograd node over the flat parameters ``p``: its
    forward returns every sampled leaf as a view of ``mu + softplus(rho) *
    eps`` (cast once to ``out_dtype``) and every det leaf as a view of
    ``p``; its backward writes ``p``'s whole gradient in one pass: the
    sampled leaves' gradients concatenated into the mu segment (in
    ``out_dtype``, then cast once), the rho segment from them as the
    mul's and softplus's backward make it, and the det leaves' gradients
    concatenated into the det segment. Per-leaf views of one tensor would
    each fill and add a gradient of their whole base instead."""

    @staticmethod
    def forward(ctx, p, eps, layout, out_dtype):
        n = eps.shape[0]
        sample = p[:n] + F.softplus(p[n:2 * n]) * eps
        if out_dtype is not None:
            sample = sample.to(out_dtype)
        ctx.save_for_backward(p, eps)
        ctx.layout, ctx.out_dtype = layout, out_dtype
        ctx.set_materialize_grads(False)
        return (tuple(sample[o:o + size].view(s)
                      for _, s, o, size in layout.sampled)
                + tuple(p[o:o + size].view(s)
                        for _, s, o, size in layout.det))

    @staticmethod
    def backward(ctx, *grads):
        p, eps = ctx.saved_tensors
        layout, low = ctx.layout, ctx.out_dtype
        n, k = eps.shape[0], len(layout.sampled)
        g = torch.empty_like(p)
        g_mu, g_rho = g[:n], g[n:2 * n]
        if k:
            like = p if low is None else p.new_empty(0, dtype=low)
            pieces = _flat_grads(grads[:k], layout.sampled, like)
            if low is None:
                torch.cat(pieces, out=g_mu)
            else:
                g_mu.copy_(torch.cat(pieces))
        torch.mul(g_mu, eps, out=g_rho)
        torch.ops.aten.softplus_backward.grad_input(
            g_rho, p[n:2 * n], 1, 20, grad_input=g_rho)
        if layout.det:
            torch.cat(_flat_grads(grads[k:], layout.det, p), out=g[2 * n:])
        _count_gathered(len(grads))
        return g, None, None, None


def sample_mfvi_tree(params: FlatParams, generator=None, out_dtype=None,
                     eps: torch.Tensor | None = None) -> dict:
    """One RT draw for the whole tree: mu + softplus(rho) * eps over the flat
    segments in one pass (cast once to ``out_dtype``), returned as a dict of
    deterministic leaves ('<path>.w', '<path>.b') plus the det leaves as
    views of the buffer. ``eps`` (length n_var, in ``eps_order``) replaces
    the standard-normal draw from ``generator``. One autograd node
    (``_Draw``) makes every leaf, so the buffer's gradient is written in
    one pass."""
    n = params.n_var
    if eps is None:
        eps = torch.randn((n,), generator=generator, device=params.flat.device)
    layout = _layout(params)
    leaves = _Draw.apply(params.flat, eps, layout, out_dtype)
    return {name: t for (name, *_), t in
            zip(layout.sampled + layout.det, leaves)}


def posterior_mean_params(params: dict) -> dict:
    """A variational parameter dict collapsed to its posterior mean (the
    eval-mode weights, vi.py:70-81): '<path>.w_mu' -> '<path>.w',
    '<path>.b_mu' -> '<path>.b', the rho leaves dropped, the rest as is."""
    out = {}
    for name, t in params.items():
        if name.endswith("_mu"):
            out[name[:-3]] = t
        elif not name.endswith("_rho"):
            out[name] = t
    return out


def kl_mfvi(params: FlatParams, prior_mu: float = 0.0,
            prior_sigma: float = 0.1, kl_type: str = "reverse"
            ) -> torch.Tensor:
    """Sum of the elementwise KL between the prior N(prior_mu, sigma_p),
    sigma_p = prior_sigma + 1e-6, and the posterior N(mu, softplus(rho)):
    KL(prior || posterior) for 'reverse', KL(posterior || prior) for
    'forward'."""
    if params.n_var == 0:
        return torch.zeros((), device=params.flat.device)
    sigma_p = prior_sigma + PRIOR_SIGMA_STABILIZER
    sigma_q = F.softplus(params.rho)
    if kl_type == "reverse":
        kl = (torch.log(sigma_q) - math.log(sigma_p)
              + (sigma_p ** 2 + (prior_mu - params.mu) ** 2)
              / (2.0 * sigma_q ** 2) - 0.5)
    elif kl_type == "forward":
        kl = (math.log(sigma_p) - torch.log(sigma_q)
              + (sigma_q ** 2 + (params.mu - prior_mu) ** 2)
              / (2.0 * sigma_p ** 2) - 0.5)
    else:
        raise ValueError(f"unknown kl_type {kl_type!r}")
    return kl.sum()


# -- the scale-mixture prior: an MC KL ----------------------------------------

_LOG_SQRT_2PI = 0.9189385332046727


class Mixture(NamedTuple):
    """A K-component Normal mixture as device tensors, made before any
    capture: ``loc``, ``scale`` (already stabilized), ``log_pi`` and the
    normalized cumulative weights ``cum`` that ``mixture_draw`` inverts."""
    loc: torch.Tensor
    scale: torch.Tensor
    log_pi: torch.Tensor
    cum: torch.Tensor

    @staticmethod
    def of(loc, scale, pi, device=None) -> "Mixture":
        pi64 = torch.as_tensor(pi, dtype=torch.float64)
        f32 = dict(dtype=torch.float32, device=device)
        return Mixture(torch.as_tensor(loc, **f32),
                       torch.as_tensor(scale, **f32),
                       torch.log(torch.as_tensor(pi, **f32)),
                       (torch.cumsum(pi64, 0) / pi64.sum()).to(**f32))


def normal_lp(x, loc, scale) -> torch.Tensor:
    return (-((x - loc) ** 2) / (2.0 * scale ** 2) - torch.log(scale)
            - _LOG_SQRT_2PI)


def mixture_lp(x: torch.Tensor, mix: Mixture) -> torch.Tensor:
    """log sum_k pi_k N(x; loc_k, scale_k), elementwise."""
    lp = normal_lp(x[..., None], mix.loc, mix.scale) + mix.log_pi
    return torch.logsumexp(lp, dim=-1)


def mixture_draw(n: int, cum: torch.Tensor, generator: torch.Generator
                 ) -> tuple:
    """One mixture draw of ``n`` elements: (component index, standard
    normal), the component by the inverse CDF of ``cum`` on uniforms (no
    host sync, so it runs inside a CUDA graph). Every mixture draw goes
    through here, so a caller can hold it to a fixed table."""
    u = torch.rand((n,), generator=generator, device=cum.device)
    comp = torch.searchsorted(cum, u, right=True).clamp_(max=len(cum) - 1)
    z = torch.randn((n,), generator=generator, device=cum.device)
    return comp, z


def kl_mfvi_mc(params: FlatParams, generator: torch.Generator, mix: Mixture,
               kl_type: str = "reverse", n_samples: int = 1) -> torch.Tensor:
    """MC estimate of the summed KL against the scale-mixture prior ``mix``
    (vi.py:219-249), differentiable in the mu / rho segments: 'reverse'
    draws from the prior and scores prior minus posterior, 'forward' draws
    from the posterior (mu + softplus(rho) * z) and scores posterior minus
    prior. One draw per element and sample, over the flat segments."""
    mu, sigma = params.mu, F.softplus(params.rho)
    total = torch.zeros((), device=params.flat.device)
    for _ in range(n_samples):
        comp, z = mixture_draw(params.n_var, mix.cum, generator)
        if kl_type == "reverse":
            s = mix.loc[comp] + mix.scale[comp] * z
            kl = mixture_lp(s, mix) - normal_lp(s, mu, sigma)
        elif kl_type == "forward":
            s = mu + sigma * z
            kl = normal_lp(s, mu, sigma) - mixture_lp(s, mix)
        else:
            raise ValueError(f"unknown kl_type {kl_type!r}")
        total = total + kl.sum() / n_samples
    return total
