"""Conv-leaf application: deterministic, RT- or LRT-variational (counterpart
of mfvi_dip_mia_tpu/nn/var_conv.py). A leaf is a dict of one site's conv
tensors: {'w', 'b'} or {'w_mu', 'w_rho', 'b_mu', 'b_rho'}, kernels OIHW.
RT and deterministic convs of a batch-1 2-D site run on the VALID conv
kernel through ops/kernels/cf_conv.py; LRT convs on the LRT double-conv
kernel through ops/kernels/lrt_conv.py. A batch above 1, or a 5-D (OIDHW)
kernel, takes F.conv2d / F.conv3d: JAX computes those with
lax.conv_general_dilated (layers.py:37-63), outside any Pallas kernel, so
they port no TPU kernel. The skip nets run batch-1 2-D sites only."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.cf_conv import conv2d_cf
from ..ops.kernels.lrt_conv import lrt_conv

REPARAMS = ("rt", "lrt")


def is_conv_leaf(node) -> bool:
    return isinstance(node, dict) and ("w" in node or "w_mu" in node)


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


def _library_conv(x, w, b, stride, padding, pad_mode) -> torch.Tensor:
    """F.conv2d / F.conv3d (by the kernel's rank) of any batch, the
    reflection pad (ReflectionPad2d / 3d) ahead of it."""
    if padding and pad_mode == "reflection":
        x = F.pad(x, (padding,) * (2 * (w.dim() - 2)), mode="reflect")
        padding = 0
    conv = F.conv3d if w.dim() == 5 else F.conv2d
    return conv(x, w, None if b is None else b.to(x.dtype), stride=stride,
                padding=padding)


def _on_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the site runs on the hand-written kernels: batch-1 2-D."""
    return w.dim() == 4 and x.dim() == 4 and x.shape[0] == 1


def draw_conv_leaf(leaf, out_shape, *, generator=None, training: bool = True,
                   skip_bias: bool = False, reparam: str = "rt",
                   site_id: int = 0) -> dict:
    """The random draws of one conv site, for its whole output of shape
    ``out_shape`` (N, O, *spatial; read by a training LRT site only):
    ``{'eps'}``, the activation noise of a training variational site under
    ``reparam='lrt'`` (``lrt_eps``), else ``{'w', 'b'}``, the kernel and
    bias it convolves with (``sample_rt_kernel``; the bias sampled after
    the kernel, None under ``skip_bias``). A row-split forward (nn/sp.py)
    draws once for the whole output and convolves each shard's slab with
    the draws sliced to it."""
    if reparam not in REPARAMS:
        raise ValueError(f"unknown reparam {reparam!r}")
    if reparam == "lrt" and is_variational_leaf(leaf) and training:
        if generator is None:
            raise ValueError("variational conv needs a generator when "
                             "training")
        return {"eps": lrt_eps(out_shape, generator, site_id)}
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
    return {"w": w, "b": b}


def conv_leaf_drawn(leaf, draws: dict, x: torch.Tensor, *, stride: int,
                    padding: int, pad_mode: str = "zero") -> torch.Tensor:
    """One conv site on ``x`` with the draws of ``draw_conv_leaf`` (the LRT
    noise of this output's shape). ``padding=0`` on a slab that carries its
    own pad rows and columns runs the same kernels as the padded site."""
    if "eps" in draws:
        eps, w_mu = draws["eps"], leaf["w_mu"]
        if _on_kernel(x, w_mu):
            return lrt_conv(x, w_mu, leaf["w_rho"], leaf.get("b_mu"),
                            leaf.get("b_rho"), stride, padding, pad_mode, eps)
        # JAX's XLA double conv (lrt_conv.py:44-72; var_conv.py:86-93 at 3-D)
        act_mu = _library_conv(x, w_mu, leaf.get("b_mu"), stride, padding,
                               pad_mode)
        act_var = _library_conv(x * x, F.softplus(leaf["w_rho"]) ** 2, None,
                                stride, padding, pad_mode)
        if leaf.get("b_rho") is not None:
            act_var = act_var + (F.softplus(leaf["b_rho"]) ** 2).reshape(
                (-1,) + (1,) * (act_var.dim() - 2))
        return act_mu + torch.sqrt(1e-16 + act_var) * eps.to(act_mu.dtype)
    w, b = draws["w"], draws["b"]
    if not _on_kernel(x, w):
        return _library_conv(x, w, b, stride, padding, pad_mode)
    return conv2d_cf(x, w, b, stride, padding, pad_mode)


def apply_conv_leaf(leaf, x: torch.Tensor, *, stride: int, padding: int,
                    generator=None, training: bool = True,
                    skip_bias: bool = False, pad_mode: str = "zero",
                    reparam: str = "rt", site_id: int = 0) -> torch.Tensor:
    """One conv site. ``skip_bias`` elides the bias (and its sample) where
    the site feeds train-mode BatchNorm directly: the per-channel constant is
    removed exactly by the mean subtraction, as in the JAX package; the
    caller decides where it holds. ``reparam='lrt'`` samples a
    training-mode variational site in activation space (var_conv.py:86-95)
    with noise from ``lrt_eps``; eval mode takes w_mu / b_mu under either
    reparameterization. ``x`` is (N, C, H, W) with an OIHW kernel or
    (N, C, D, H, W) with an OIDHW one. ``draw_conv_leaf``, then
    ``conv_leaf_drawn``."""
    shape = None
    if reparam == "lrt" and is_variational_leaf(leaf):
        w_mu = leaf["w_mu"]
        shape = (x.shape[0], w_mu.shape[0]) + tuple(
            (n + 2 * padding - k) // stride + 1
            for n, k in zip(x.shape[2:], w_mu.shape[2:]))
    draws = draw_conv_leaf(leaf, shape, generator=generator,
                           training=training, skip_bias=skip_bias,
                           reparam=reparam, site_id=site_id)
    return conv_leaf_drawn(leaf, draws, x, stride=stride, padding=padding,
                           pad_mode=pad_mode)
