"""The port's mean-field VI (mfvi_dip_mia_tpu_torch/bayes/vi.py) and flat
AdamW (optim/fused_adamw.py) against the JAX package's bayes/vi.py and
optim/fused_adamw.py on the same parameters, carried across by
utils/bridge.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.optim.fused_adamw import flat_adamw
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.optim.fused_adamw import flat_adamw_update
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, eps_pair, jax_sample_with_eps

torch.set_num_threads(1)

# the bench's CT prior (temp 2.2e-10, sigma 1.7e-7: the +1e-6 stabilizer
# dominates) and one where the KL gradient outweighs the data gradient
PRIORS = [(2.2e-10, 1.7e-7), (1e-3, 0.1)]
# f32 sums of ~3e4 KL terms, each summed in another order
KL_REL = 1e-5
# elementwise f32 AdamW on identical inputs: rounding only
ADAMW_REL = 1e-6


@pytest.fixture(scope="module")
def trees():
    net = jbuild(16, n_channels=2, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    params_j = jax.tree.map(jnp.asarray, jvi.to_mfvi(net.init(k1), k2))
    flat = tvi.flatten(bridge.params_from_jax(
        jax.tree.map(np.asarray, params_j)))
    return params_j, flat


def _prior_sigma(temp, sigma):
    return float(np.sqrt(temp) * sigma)


def test_to_mfvi_matches_the_jax_leaf_shapes_and_moments():
    net_t = tbuild(16, n_channels=2, **SMALL_NET)
    det = net_t.init_params(torch.Generator().manual_seed(0))
    var = tvi.to_mfvi(det, torch.Generator().manual_seed(1))
    net_j = jbuild(16, n_channels=2, **SMALL_NET)
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, jvi.to_mfvi(
        net_j.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))))
    assert {k: tuple(v.shape) for k, v in var.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    mu = torch.cat([v.reshape(-1) for k, v in var.items()
                    if k.endswith("_mu")])
    rho = torch.cat([v.reshape(-1) for k, v in var.items()
                     if k.endswith("_rho")])
    # N(0, 0.1) and N(-3, 0.1) over ~1.5e4 draws each
    assert abs(float(mu.mean())) < 5e-3 and abs(float(mu.std()) - 0.1) < 5e-3
    assert (abs(float(rho.mean()) + 3.0) < 5e-3
            and abs(float(rho.std()) - 0.1) < 5e-3)
    # BN affine stays deterministic (ones / zeros)
    assert all(torch.equal(var[k], det[k]) for k in det if ".bn" in k)


@pytest.mark.parametrize("temp,sigma", PRIORS)
def test_kl_matches_jax(trees, temp, sigma):
    params_j, flat = trees
    ps = _prior_sigma(temp, sigma)
    ref = float(jvi.kl_mfvi(params_j, 0.0, ps))
    got = tvi.kl_mfvi(flat, 0.0, ps)
    assert torch.isfinite(got)
    assert abs(float(got) - ref) <= KL_REL * abs(ref)


def test_sample_with_supplied_eps_matches_jax(trees):
    params_j, flat = trees
    eps_j, eps_t = eps_pair(params_j, flat, seed=12)
    ref = bridge.params_from_jax(jax.tree.map(
        np.asarray, jax_sample_with_eps(params_j, eps_j)))
    got = tvi.sample_mfvi_tree(flat, eps=eps_t)
    assert set(got) == set(ref)
    for name, r in ref.items():
        torch.testing.assert_close(got[name], r, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("temp,sigma", PRIORS)
def test_analytic_kl_gradient_is_the_autograd_gradient(trees, temp, sigma):
    """flat_adamw_update's fused KL term equals temp * d(kl_mfvi)/d(mu, rho)
    (optim/fused_adamw.py:120-137)."""
    _, flat = trees
    ps = _prior_sigma(temp, sigma)
    p = flat.flat.clone().requires_grad_(True)
    (temp * tvi.kl_mfvi(flat.with_flat(p), 0.0, ps)).backward()
    zeros = torch.zeros_like(flat.flat)
    # with lr = 1, b1 = 0 and the first step's bias correction, m equals g
    _, m, _, _ = flat_adamw_update(
        flat.flat, zeros, zeros, zeros, torch.zeros((), dtype=torch.int32),
        lr=1.0, n_var=flat.n_var, kl_temp=temp, kl_prior_sigma=ps,
        use_kl=True, b1=0.0)
    torch.testing.assert_close(m, p.grad, rtol=1e-5,
                               atol=1e-6 * float(p.grad.abs().max()))


@pytest.mark.parametrize("temp,sigma", PRIORS)
def test_two_flat_adamw_steps_match_jax(trees, temp, sigma):
    params_j, flat = trees
    ps = _prior_sigma(temp, sigma)
    lr = 1e-3
    rng = np.random.default_rng(13)
    grads_np = [jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32),
        jax.tree.map(np.asarray, params_j)) for _ in range(2)]

    tx = flat_adamw(lr, 0.0, temp, ps, use_kl=True)
    state = tx.init(params_j)
    pj = params_j
    for g in grads_np:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda a, u: a + u, pj, upd)
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, pj))

    p, m, v = flat.flat.clone(), torch.zeros_like(flat.flat), \
        torch.zeros_like(flat.flat)
    count = torch.zeros((), dtype=torch.int32)
    for g in grads_np:
        by_name = bridge.params_from_jax(g)
        g_flat = torch.cat([by_name[n].reshape(-1) for n in flat.names])
        p, m, v, count = flat_adamw_update(
            p, g_flat, m, v, count, lr=lr, n_var=flat.n_var, kl_temp=temp,
            kl_prior_sigma=ps, use_kl=True)
    assert int(count) == 2
    got = flat.with_flat(p).leaves()
    init = flat.leaves()
    for name, r in ref.items():
        # compare the two steps' displacement, ~lr in size
        d_ref = r - init[name]
        d_got = got[name] - init[name]
        assert float((d_got - d_ref).abs().max()) <= ADAMW_REL * 2 * lr + \
            1e-7 * float(init[name].abs().max()), name


def test_flatten_keeps_the_leaves_device_by_default():
    """Without ``device`` the flat buffer stays where the leaves are (here
    the meta device, which cannot be copied to the CPU); with it, it moves."""
    leaves = {"a.w_mu": torch.ones(3), "a.w_rho": torch.zeros(3),
              "a.b": torch.full((2,), 2.0)}
    meta = tvi.flatten({k: v.to("meta") for k, v in leaves.items()})
    assert meta.flat.device.type == "meta" and meta.flat.shape == (8,)
    cpu = tvi.flatten(leaves, device="cpu")
    assert cpu.flat.device.type == "cpu"
    assert cpu.flat.tolist() == [1, 1, 1, 0, 0, 0, 2, 2] and cpu.n_var == 3
