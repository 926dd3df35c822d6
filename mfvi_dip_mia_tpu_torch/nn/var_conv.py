"""Conv-leaf application, deterministic or RT-variational (counterpart of
mfvi_dip_mia_tpu/nn/var_conv.py). A leaf is a dict of one site's conv
tensors: {'w', 'b'} or {'w_mu', 'w_rho', 'b_mu', 'b_rho'}, kernels OIHW.
Every conv runs on the VALID conv kernel through ops/kernels/cf_conv.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.cf_conv import conv2d_cf


def is_variational_leaf(node) -> bool:
    return isinstance(node, dict) and "w_mu" in node


def _normal_like(t: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(t.shape, generator=generator, device=t.device,
                       dtype=t.dtype)


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
                    skip_bias: bool = False,
                    pad_mode: str = "zero") -> torch.Tensor:
    """One conv site. ``skip_bias`` elides the bias (and its sample) where
    the site feeds train-mode BatchNorm directly: the per-channel constant is
    removed exactly by the mean subtraction, as in the JAX package. Local
    reparameterization (LRT) waits for its slice."""
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
