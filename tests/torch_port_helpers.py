"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: one numpy eps vector feeding both sides' whole-tree RT draw, and
the small nets the port's tests run."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.utils import bridge

SMALL_NET = dict(pad="reflection", skip_n33d=[16, 32], skip_n33u=[16, 32],
                 skip_n11=4, num_scales=2, upsample_mode="bilinear")


def jax_eps_order(tree):
    """(sampled-leaf name, JAX shape) in the order jvi._collect_variational
    walks ``tree`` (its own dict order: a tree that came out of jit has
    sorted keys)."""
    order = []

    def rec(node, prefix):
        if jvi.is_variational_leaf(node):
            order.append((prefix + "w", tuple(node["w_mu"].shape)))
            if node.get("b_mu") is not None:
                order.append((prefix + "b", tuple(node["b_mu"].shape)))
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}.")

    rec(tree, "")
    return order


def jax_sample_with_eps(params, eps, out_dtype=None):
    """vi.sample_mfvi_tree with a supplied eps vector in place of the
    normal draw (bayes/vi.py:109-134)."""
    pairs = jvi._collect_variational(params)
    mu = jnp.concatenate([m.reshape(-1) for m, _ in pairs])
    rho = jnp.concatenate([r.reshape(-1) for _, r in pairs])
    flat = mu + jax.nn.softplus(rho) * jnp.asarray(eps, mu.dtype)
    if out_dtype is not None:
        flat = flat.astype(out_dtype)
    offs = np.cumsum([0] + [m.size for m, _ in pairs])
    chunks = iter(flat[offs[i]:offs[i + 1]] for i in range(len(pairs)))

    def transform(leaf, _k):
        if not jvi.is_variational_leaf(leaf):
            return leaf
        out = {"w": next(chunks).reshape(leaf["w_mu"].shape)}
        out["b"] = (next(chunks).reshape(leaf["b_mu"].shape)
                    if leaf.get("b_mu") is not None else None)
        return out

    return jvi._map_conv_leaves(params, transform, jax.random.PRNGKey(0))


def eps_pair(jax_tree, port_params: tvi.FlatParams, seed=0):
    """One standard-normal eps, as the JAX vector (in ``jax_tree``'s walk
    order, HWIO kernels) and the port's (in its eps_order, OIHW)."""
    rng = np.random.default_rng(seed)
    by_name = {}
    chunks = []
    for name, shape in jax_eps_order(jax_tree):
        e = rng.standard_normal(shape).astype(np.float32)
        by_name[name] = e
        chunks.append(e.reshape(-1))
    port = [bridge.leaf_from_jax(name, by_name[name]).reshape(-1)
            for name, _ in tvi.eps_order(port_params)]
    return np.concatenate(chunks), torch.cat(port)
