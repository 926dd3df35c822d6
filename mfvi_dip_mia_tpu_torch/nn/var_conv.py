"""Conv-leaf application: deterministic, RT- or LRT-variational (counterpart
of mfvi_dip_mia_tpu/nn/var_conv.py). A leaf is a dict of one site's conv
tensors: {'w', 'b'} or {'w_mu', 'w_rho', 'b_mu', 'b_rho'}, kernels OIHW.
RT and deterministic convs run on the VALID conv kernel through
ops/kernels/cf_conv.py; LRT convs on the LRT double-conv kernel through
ops/kernels/lrt_conv.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.cf_conv import conv2d_cf
from ..ops.kernels.lrt_conv import lrt_conv

REPARAMS = ("rt", "lrt")


def is_variational_leaf(node) -> bool:
    return isinstance(node, dict) and "w_mu" in node


def _normal_like(t: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(t.shape, generator=generator, device=t.device,
                       dtype=t.dtype)


def lrt_eps(shape, generator: torch.Generator, site_id: int) -> torch.Tensor:
    """The standard-normal activation noise of LRT site ``site_id`` (f32, on
    the generator's device). Every LRT draw goes through here, so a caller
    can hold it to fixed per-site noise; JAX draws it from fold_in(key,
    site_id) (skip.py:289-290, lrt_conv.py:64)."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device)


def sample_rt_kernel(leaf, generator, training: bool) -> torch.Tensor:
    """The kernel an RT (or deterministic) site uses:
    w_mu + softplus(w_rho) * eps in training, w_mu in eval."""
    if not is_variational_leaf(leaf):
        return leaf["w"]
    if not training:
        return leaf["w_mu"]
    if generator is None:
        raise ValueError("variational conv needs a generator when training")
    return leaf["w_mu"] + F.softplus(leaf["w_rho"]) * _normal_like(
        leaf["w_mu"], generator)


def apply_conv_leaf(leaf, x: torch.Tensor, *, stride: int, padding: int,
                    generator=None, training: bool = True,
                    skip_bias: bool = False, pad_mode: str = "zero",
                    reparam: str = "rt", site_id: int = 0) -> torch.Tensor:
    """One conv site. ``skip_bias`` elides the bias (and its sample) where
    the site feeds train-mode BatchNorm directly: the per-channel constant is
    removed exactly by the mean subtraction, as in the JAX package; the
    caller decides where it holds. ``reparam='lrt'`` samples a training-mode variational site in activation space
    (var_conv.py:86-95) with noise from ``lrt_eps``; eval mode takes
    w_mu / b_mu under either reparameterization."""
    if reparam not in REPARAMS:
        raise ValueError(f"unknown reparam {reparam!r}")
    lrt = reparam == "lrt" and is_variational_leaf(leaf)
    if lrt and training:
        if generator is None:
            raise ValueError("variational conv needs a generator when "
                             "training")
        w_mu = leaf["w_mu"]
        shape = (1, w_mu.shape[0],
                 (x.shape[2] + 2 * padding - w_mu.shape[2]) // stride + 1,
                 (x.shape[3] + 2 * padding - w_mu.shape[3]) // stride + 1)
        return lrt_conv(x, w_mu, leaf["w_rho"], leaf.get("b_mu"),
                        leaf.get("b_rho"), stride, padding, pad_mode,
                        lrt_eps(shape, generator, site_id))
    w = sample_rt_kernel(leaf, generator, training)
    b = None
    if not skip_bias:
        if is_variational_leaf(leaf):
            b_mu = leaf.get("b_mu")
            if b_mu is not None:
                b = (b_mu + F.softplus(leaf["b_rho"])
                     * _normal_like(b_mu, generator) if training else b_mu)
        else:
            b = leaf.get("b")
    return conv2d_cf(x, w, b, stride, padding, pad_mode)
