"""Carry parameters, noise and fitted GPs across from the JAX package
(mfvi_dip_mia_tpu).

The JAX parameter tree arrives as nested dicts / lists of numpy arrays (the
caller converts it with np.asarray; this module never sees JAX). HWIO conv
kernels (``w``, ``w_mu``, ``w_rho``) become OIHW, DHWIO ones OIDHW; biases
and BatchNorm ``scale``/``offset`` copy as they are. Leaf names keep the JAX
paths, e.g. ``levels.0.down1.conv.w_mu`` or a classifier's ``l1.w_mu``.
"""

from __future__ import annotations

import numpy as np
import torch

_KERNEL_LEAVES = ("w", "w_mu", "w_rho")


def leaf_from_jax(name: str, value) -> torch.Tensor:
    """One JAX leaf -> the port's tensor: HWIO conv kernels become OIHW,
    DHWIO ones (3-D variational leaves) OIDHW."""
    a = np.array(value, np.float32)          # a writable copy
    if name.rsplit(".", 1)[-1] in _KERNEL_LEAVES and a.ndim in (4, 5):
        a = np.moveaxis(a, (-1, -2), (0, 1))
    return torch.from_numpy(np.ascontiguousarray(a))


def named_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree in its own iteration
    order; None leaves (absent biases) are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def params_from_jax(tree) -> dict:
    """The JAX parameter tree -> the port's parameter dict (name -> tensor),
    in the tree's own order."""
    return {name: leaf_from_jax(name, v) for name, v in named_leaves(tree)}


def gp_from_jax(params, x_train, y_train):
    """A GP fitted by the JAX package -> the port's ``bo.gp.ExactGP``.
    ``params`` are the four values of JAX's ``GPParams`` in its field order
    (raw_lengthscale, raw_outputscale, raw_noise, mean_const), the training
    arrays (n, 2) and (n,); all numpy. The Cholesky factor and the weights
    are computed anew from them, in float64 on the CPU."""
    from ..bo.gp import ExactGP, GPParams
    return ExactGP.fitted(
        GPParams(*(np.asarray(v, np.float64) for v in params)),
        x_train, y_train)
