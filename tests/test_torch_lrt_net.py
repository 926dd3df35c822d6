"""The LRT path as a whole: the port's skip U-Net, ``fit`` and ``mc_predict``
under ``reparam='lrt'`` against the JAX package's, on the same weights
(carried across by utils/bridge.py: LRT uses the RT mu / rho tree, no new
leaf) and the same fixed activation noise per site.

The JAX net runs layout='nhwc' (its channels-first path draws the noise in
another order, cf.py:194-195) with MFVI_DIP_PALLAS_LRT=1, so its stride-1
sites take the Pallas LRT kernel (interpret mode here). Its noise comes from
a copy of lrt_conv.py:47-65 that takes the table's eps in call order; the
port's from a substitute ``nn/var_conv.py::lrt_eps`` that looks the table up
by site id."""

import os
import weakref

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.ops.pallas.lrt_conv as jlrt
import mfvi_dip_mia_tpu.tasks.trainer as JT
from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.ops.pallas import lrt_conv_pallas as jlp
import mfvi_dip_mia_tpu_torch.nn.var_conv as tvc
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.bayes.uncertainty import mc_predict
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_torch_trainer import PRIORS, _check_lockstep, _patch_problems
from torch_port_helpers import SMALL_NET

torch.set_num_threads(1)

# forward: the tolerance of test_skip.py's torch-transplant golden (ROADMAP
# parity tier (a))
GOLDEN = dict(atol=2e-4, rtol=1e-3)
# parameter gradients, as a share of the tree's largest gradient: the same
# f32 function in another summation order (as test_torch_skip.py)
GRAD_REL = 1e-4


class EpsTable:
    """One fixed standard-normal eps per LRT site, drawn from numpy at the
    first forward (NCHW, keyed by site id); ``order`` is the port's call
    order of the sites, which the JAX net shares."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.by_site = {}
        self.order = []

    def port_eps(self, shape, generator, site_id):
        if site_id not in self.by_site:
            self.by_site[site_id] = self.rng.standard_normal(
                tuple(shape)).astype(np.float32)
            self.order.append(site_id)
        assert self.by_site[site_id].shape == tuple(shape)
        return torch.from_numpy(self.by_site[site_id])

    def jax_lrt_conv(self, used_pallas):
        """lrt_conv.py:47-65 with the table's eps (NHWC) in call order; a
        new trace starts the order again."""
        calls = [0]

        def lrt_conv(x, w_mu, w_rho, b_mu, b_rho, stride, padding, key):
            w_sigma2 = jax.nn.softplus(w_rho) ** 2
            if (os.environ.get("MFVI_DIP_PALLAS_LRT") == "1"
                    and jlp.supported(x, w_mu, stride, padding)):
                act_mu, act_var = jlp.lrt_double_conv_pallas(
                    x, w_mu, w_sigma2, stride, padding)
                used_pallas.append(True)
            else:
                act_mu, act_var = jlrt._fused_double_conv(
                    x, w_mu, w_sigma2, stride, padding)
                used_pallas.append(False)
            if b_mu is not None:
                act_mu = act_mu + b_mu
                act_var = act_var + jax.nn.softplus(b_rho) ** 2
            site = self.order[calls[0] % len(self.order)]
            calls[0] += 1
            eps = jnp.asarray(self.by_site[site].transpose(0, 2, 3, 1))
            assert eps.shape == act_mu.shape, (site, eps.shape, act_mu.shape)
            return act_mu + jnp.sqrt(1e-16 + act_var) * eps

        return lrt_conv


@pytest.fixture
def eps_table(monkeypatch):
    table = EpsTable(seed=31)
    used_pallas = []
    monkeypatch.setenv("MFVI_DIP_PALLAS_LRT", "1")
    monkeypatch.setattr(tvc, "lrt_eps", table.port_eps)
    monkeypatch.setattr(jlrt, "lrt_conv", table.jax_lrt_conv(used_pallas))
    return table, used_pallas


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def nets():
    net_j = jbuild(16, n_channels=2, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(13))
    params_j = jax.tree.map(jnp.asarray, jvi.to_mfvi(net_j.init(k1), k2))
    params_t = bridge.params_from_jax(jax.tree.map(np.asarray, params_j))
    x = (np.random.default_rng(14).uniform(size=(1, 32, 64, 16)) * 0.1
         ).astype(np.float32)
    return net_j, params_j, tbuild(16, n_channels=2, **SMALL_NET), params_t, x


def test_lrt_forward_golden_against_jax(eps_table, nets):
    table, used_pallas = eps_table
    net_j, params_j, net_t, params_t, x = nets
    with torch.no_grad():
        out_t = net_t(params_t, _nchw(x), torch.Generator(), reparam="lrt")
    assert sorted(table.order) == list(range(net_t.num_conv_sites))
    out_j = jax.jit(lambda p: net_j.apply(
        p, jnp.asarray(x), key=jax.random.PRNGKey(0), training=True,
        reparam="lrt", layout="nhwc"))(params_j)
    assert len(used_pallas) == net_t.num_conv_sites
    assert sum(used_pallas) == 9      # every stride-1 site of the 2-scale net
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)


def test_lrt_parameter_gradients_against_jax(eps_table, nets, monkeypatch):
    """Every mu / rho / BN leaf's gradient of an MSE through the LRT net,
    the port's autograd (LRT backward on the conv dx / dw paths) against
    jax.grad. The JAX side runs its XLA double conv: the Pallas kernel's
    backward is the same XLA code (lrt_conv_pallas.py:174-209), and its
    forward is held above."""
    monkeypatch.delenv("MFVI_DIP_PALLAS_LRT")
    net_j, params_j, net_t, params_t, x = nets
    tgt = np.random.default_rng(15).uniform(size=(1, 32, 64, 2)).astype(
        np.float32)
    flat = tvi.flatten(params_t)
    p = flat.flat.clone().requires_grad_(True)
    out = net_t(flat.with_flat(p).leaves(), _nchw(x), torch.Generator(),
                reparam="lrt")
    torch.mean((out - _nchw(tgt)) ** 2).backward()
    g_t = flat.with_flat(p.grad).leaves()

    def loss_j(pj):
        out = net_j.apply(pj, jnp.asarray(x), key=jax.random.PRNGKey(0),
                          training=True, reparam="lrt", layout="nhwc")
        return jnp.mean((out - tgt) ** 2)

    g_ref = bridge.params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_j))(params_j)))
    assert set(g_t) == set(g_ref)
    scale = max(float(v.abs().max()) for v in g_ref.values())
    for name, ref in g_ref.items():
        err = float((g_t[name] - ref).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)
    # the bias of a site before BN gets a gradient under LRT (its variance
    # feeds the noise), where RT elides it
    assert float(g_t["levels.0.down2.conv.b_rho"].abs().max()) > 0


def test_unsampled_leaves_carry_autograd_to_flat(nets):
    """bayes/vi.py: the mu / rho leaves the LRT net reads are views of the
    flat buffer, so one backward fills both segments of its gradient."""
    *_, net_t, params_t, x = nets
    flat = tvi.flatten(params_t)
    p = flat.flat.clone().requires_grad_(True)
    leaves = flat.with_flat(p).leaves()
    assert all(v._base is p for v in leaves.values())
    net_t(leaves, _nchw(x), torch.Generator().manual_seed(0),
          reparam="lrt").square().mean().backward()
    for seg in (p.grad[:flat.n_var], p.grad[flat.n_var:2 * flat.n_var]):
        assert torch.isfinite(seg).all() and float(seg.abs().max()) > 0


@pytest.fixture
def lrt_lockstep(monkeypatch, eps_table):
    """test_torch_trainer.py's lockstep harness under LRT: no whole-tree
    draw to fix, so both sides share the eps table instead."""
    _patch_problems(monkeypatch, 64)
    for T in (JT, TT):
        monkeypatch.setattr(T, "REG_NOISE_STD", 0.0)
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE", {})
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE_WEAK",
                        weakref.WeakKeyDictionary())
    import mfvi_dip_mia_tpu.tasks.problems as JP
    import mfvi_dip_mia_tpu_torch.tasks.problems as TP
    prob_j = JP.build_problem("den", "mfvi", 0, input_depth=16)
    prob_t = TP.build_problem("den", "mfvi", 0, input_depth=16, device="cpu")
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    params_j = jax.tree.map(jnp.asarray, jvi.to_mfvi(prob_j.net.init(k1), k2))
    params_np = jax.tree.map(np.asarray, params_j)
    monkeypatch.setattr(
        JT, "_get_init_fn", lambda problem, name, optimizer, std:
        (lambda *keys: (params_j, optimizer.init(params_j))))
    monkeypatch.setattr(TT, "init_params", lambda problem, method, seed:
                        bridge.params_from_jax(params_np))
    return prob_j, prob_t


def test_lrt_fit_lockstep_against_jax(lrt_lockstep, eps_table):
    _, used_pallas = eps_table
    prob_j, prob_t = lrt_lockstep
    _check_lockstep(prob_j, prob_t, "den", reparam="lrt")
    assert any(used_pallas)


def test_mc_predict_under_lrt_draws_fresh_noise_per_sample(nets):
    *_, net_t, params_t, x = nets
    flat = tvi.flatten(params_t)
    calls = []
    fwd = tlrt.double_conv_fwd

    def spy(*args):
        calls.append(1)
        return fwd(*args)

    tlrt.double_conv_fwd, saved = spy, tlrt.double_conv_fwd
    try:
        outs = mc_predict(net_t, flat, _nchw(x),
                          torch.Generator().manual_seed(3), 3, reparam="lrt")
    finally:
        tlrt.double_conv_fwd = saved
    assert outs.shape == (3, 1, 2, 32, 64)
    assert torch.isfinite(outs).all()
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])
    assert len(calls) == 3 * net_t.num_conv_sites
    with pytest.raises(ValueError, match="reparam"):
        mc_predict(net_t, flat, _nchw(x), torch.Generator(), 1,
                   reparam="flipout")


def test_lrt_sites_of_the_five_scale_net(monkeypatch):
    """All 26 conv sites of the 256^2 nets' topology take the LRT kernel
    under LRT (five stride-2 down1 sites on parity planes), none the fused
    block; JAX's TPU gate (lrt_conv_pallas.py::supported) sends 20 of them
    to its kernel at 256^2 and keeps the five stride-2 sites and level 4's
    down2 (8 wide) on XLA."""
    fused, lrt = [], []
    monkeypatch.setattr(tfb, "apply_fused",
                        lambda *a, **k: fused.append(1))
    fwd = tlrt.double_conv_fwd
    monkeypatch.setattr(tlrt, "double_conv_fwd",
                        lambda *a: lrt.append(tuple(a[0].shape)) or fwd(*a))
    kw = dict(pad="reflection", skip_n33d=[16, 32, 64, 128, 128],
              skip_n33u=[16, 32, 64, 128, 128], skip_n11=4, num_scales=5,
              upsample_mode="bilinear")
    net = tbuild(16, n_channels=2, **kw)
    flat = tvi.flatten(tvi.to_mfvi(
        net.init_params(torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1)))
    with torch.no_grad():
        out = net(flat.leaves(), torch.rand(1, 16, 64, 64) * 0.1,
                  torch.Generator().manual_seed(2), reparam="lrt")
    assert out.shape == (1, 2, 64, 64) and torch.isfinite(out).all()
    assert fused == [] and len(lrt) == 26
    # JAX's gate at 256^2, from shapes alone
    net_j = jbuild(16, n_channels=2, **kw)
    jax_sites = 0
    for i, cfg in enumerate(net_j.levels):
        s = 256 >> i
        for site, s_in in ((cfg.skip_conv, s), (cfg.down1, s),
                           (cfg.down2, s // 2), (cfg.up, s), (cfg.up1x1, s)):
            p = (site.kernel - 1) // 2
            # NHWC reflection sites arrive padded, with padding 0
            x = np.zeros((1, s_in + 2 * p, s_in + 2 * p, site.c_in), np.int8)
            w = np.zeros((site.kernel, site.kernel, site.c_in, site.c_out),
                         np.int8)
            jax_sites += jlp.supported(x, w, site.stride, 0)
    out_w = np.zeros((1, 1, net_j.out_conv.c_in, net_j.out_conv.c_out))
    jax_sites += jlp.supported(np.zeros((1, 256, 256, 16), np.int8), out_w,
                               1, 0)
    assert jax_sites == 20
