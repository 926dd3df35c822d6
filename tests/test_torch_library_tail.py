"""The port's library tail against the JAX package's: the conv leaf at a
batch above 1 and with 3-D kernels (nn/var_conv.py), the bridge's 3-D
kernels, the classification uncertainty / SNR pruning / KL warm-up
(bayes/uncertainty.py), Gaussian dropout (bayes/dropout.py), the
classification trainer (bayes/classification.py), the SGLD family
(optim/sgld.py), the TV and NLLLoss2d losses, the image helpers, the three
histogram / calibration plots and utils/profiling.py. Same seeded numpy
inputs on both sides, the CPU, plain versions; the JAX draws are
substituted into the port where a draw enters."""

import importlib
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.bayes import dropout as jdrop
from mfvi_dip_mia_tpu.bayes import uncertainty as junc
from mfvi_dip_mia_tpu.bayes import classification as jcls
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.nn import init as jinit
from mfvi_dip_mia_tpu.nn import var_conv as jvc
from mfvi_dip_mia_tpu.ops import losses as jlosses
from mfvi_dip_mia_tpu.utils import images as jimg
from mfvi_dip_mia_tpu_torch.bayes import classification as tcls
from mfvi_dip_mia_tpu_torch.bayes import dropout as tdrop
from mfvi_dip_mia_tpu_torch.bayes import priors as tpriors
from mfvi_dip_mia_tpu_torch.bayes import uncertainty as tunc
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import var_conv as tvc
from mfvi_dip_mia_tpu_torch.ops import losses as tlosses
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt
from mfvi_dip_mia_tpu_torch.optim import sgld as tsgld
from mfvi_dip_mia_tpu_torch.optim.transform import apply_updates
from mfvi_dip_mia_tpu_torch.utils import bridge
from mfvi_dip_mia_tpu_torch.utils import images as timg
from mfvi_dip_mia_tpu_torch.utils import profiling as tprof
from mfvi_dip_mia_tpu_torch.utils import viz as tviz

from torch_port_helpers import SMALL_NET

# the module (the package's __init__ exports a function of the same name)
jsgld = importlib.import_module("mfvi_dip_mia_tpu.optim.sgld")

torch.set_num_threads(1)

# the same f32 function in another summation order
ATOL = 1e-5
# one optimizer step, noise-free: the same elementwise f32 formulas
STEP_REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _to_nc(a):
    """NHWC / NDHWC numpy -> NCHW / NCDHW tensor."""
    a = np.asarray(a, np.float32)
    return _t(np.moveaxis(a, -1, 1))


def _from_nc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# -- the conv leaf at a batch above 1 and with 3-D kernels --------------------

def _leaf_pair(rng, kshape, variational=True):
    """A conv leaf as JAX's (HWIO / DHWIO) and the port's (OIHW / OIDHW)."""
    o = kshape[-1]
    if variational:
        leaf_j = {"w_mu": rng.normal(0, 0.2, kshape),
                  "w_rho": rng.normal(-3, 0.1, kshape),
                  "b_mu": rng.normal(0, 0.1, (o,)),
                  "b_rho": rng.normal(-3, 0.1, (o,))}
    else:
        leaf_j = {"w": rng.normal(0, 0.2, kshape), "b": rng.normal(0, 0.1, (o,))}
    leaf_j = {k: np.asarray(v, np.float32) for k, v in leaf_j.items()}
    leaf_t = {k: bridge.leaf_from_jax(k, v) for k, v in leaf_j.items()}
    return {k: jnp.asarray(v) for k, v in leaf_j.items()}, leaf_t


def _queue(monkeypatch, module, name, tensors):
    """Replace ``module.name`` (a draw) with one returning ``tensors`` in
    turn."""
    it = iter(tensors)
    monkeypatch.setattr(module, name, lambda *a, **k: next(it))


CASES = {
    # name: (input shape NHWC / NDHWC, kernel HWIO / DHWIO, stride, padding)
    "2-D batch 4": ((4, 9, 11, 3), (3, 3, 3, 5), 1, 1),
    "2-D batch 4 stride 2": ((4, 10, 12, 3), (3, 3, 3, 5), 2, 1),
    "3-D batch 2": ((2, 5, 6, 7, 2), (3, 3, 3, 2, 4), 1, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["det", "rt", "lrt", "eval"])
def test_apply_conv_leaf_batch_and_3d_against_jax(monkeypatch, case, mode):
    """A batch above 1 and a 5-D kernel take F.conv2d / F.conv3d, as JAX's
    lax.conv does (no "batch-1 NCHW input expected"). The draws are JAX's,
    substituted."""
    xs, ks, stride, padding = CASES[case]
    rng = np.random.default_rng(zlib.crc32(f"{case}/{mode}".encode()))
    x = rng.uniform(-1, 1, xs).astype(np.float32)
    leaf_j, leaf_t = _leaf_pair(rng, ks, variational=mode != "det")
    key = jax.random.PRNGKey(5)
    training = mode != "eval"
    reparam = "lrt" if mode == "lrt" else "rt"
    out_j = jvc.apply_conv_leaf(leaf_j, jnp.asarray(x), stride=stride,
                                padding=padding, key=key, training=training,
                                reparam=reparam)
    if mode == "rt":
        kw, kb = jax.random.split(key)
        eps_w = jax.random.normal(kw, ks)
        eps_b = jax.random.normal(kb, (ks[-1],))
        _queue(monkeypatch, tvc, "_normal_like",
               [bridge.leaf_from_jax("w", eps_w), _t(eps_b)])
    if mode == "lrt":
        eps = jax.random.normal(key, out_j.shape)
        monkeypatch.setattr(tvc, "lrt_eps", lambda shape, g, sid: _to_nc(eps))
    gen = torch.Generator().manual_seed(0)
    out_t = tvc.apply_conv_leaf(leaf_t, _to_nc(x), stride=stride,
                                padding=padding, generator=gen,
                                training=training, reparam=reparam)
    assert out_t.shape == _to_nc(np.asarray(out_j)).shape
    np.testing.assert_allclose(_from_nc(out_t), np.asarray(out_j), atol=ATOL)


def test_batch_one_2d_sites_stay_on_the_kernel(monkeypatch):
    calls = []
    conv = tvc.conv2d_cf
    monkeypatch.setattr(tvc, "conv2d_cf",
                        lambda *a, **k: calls.append(1) or conv(*a, **k))
    rng = np.random.default_rng(1)
    _, leaf_t = _leaf_pair(rng, (3, 3, 3, 4), variational=False)
    tvc.apply_conv_leaf(leaf_t, torch.rand(1, 3, 8, 8), stride=1, padding=1)
    assert calls == [1]
    tvc.apply_conv_leaf(leaf_t, torch.rand(2, 3, 8, 8), stride=1, padding=1)
    assert calls == [1]


def test_is_conv_leaf_as_jax():
    for node in ({"w": 1}, {"w_mu": 1, "w_rho": 2}, {"scale": 1}, [1], None,
                 {"b": 1}):
        assert tvc.is_conv_leaf(node) == jvc.is_conv_leaf(node)


def test_bridge_carries_3d_and_classifier_leaves():
    a = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6)
    t = bridge.leaf_from_jax("conv.w_rho", a)
    assert t.shape == (6, 5, 2, 3, 4)
    np.testing.assert_array_equal(t.numpy(), a.transpose(4, 3, 0, 1, 2))
    params = _mlp_params_j()
    port = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    assert set(port) == {f"{l}.{k}_{s}" for l in ("l1", "l2")
                         for k in ("w", "b") for s in ("mu", "rho")}
    assert port["l1.w_mu"].shape == (16, 2, 1, 1)
    np.testing.assert_array_equal(
        port["l1.w_mu"].numpy()[:, :, 0, 0],
        np.asarray(params["l1"]["w_mu"])[0, 0].T)


# -- uncertainty: Kwon, SNR, pruning, KL warm-up --------------------------------

@pytest.mark.parametrize("beta_type", ["Blundell", "Soenderby", "Standard",
                                       0.25])
def test_get_beta_against_jax(beta_type):
    for m in (1, 4, 40):
        for i in range(min(m, 6)):
            kw = dict(epoch=i + 1, num_epochs=12, batch_idx=i, m=m)
            b_t, b_j = tunc.get_beta(beta_type, **kw), junc.get_beta(
                beta_type, **kw)
            assert float(b_t) == pytest.approx(float(b_j), rel=1e-12)
    if beta_type == "Blundell":
        idx = torch.arange(8)
        b_t = tunc.get_beta("Blundell", batch_idx=idx, m=8)
        b_j = jax.vmap(lambda i: junc.get_beta("Blundell", batch_idx=i,
                                               m=8))(jnp.arange(8))
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6)
        assert float(b_t.sum()) == pytest.approx(1.0, rel=1e-6)
        assert float(tunc.get_beta("Blundell", batch_idx=torch.tensor(500),
                                   m=2000)) == 0.0
    if beta_type == "Soenderby":
        with pytest.raises(ValueError):
            tunc.get_beta("Soenderby")


def test_kwon_and_snr_against_jax(rng):
    logits = rng.standard_normal((6, 4, 3, 5, 5)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=2))
    for got, ref in zip(tunc.uncert_classification_kwon(_t(probs)),
                        junc.uncert_classification_kwon(jnp.asarray(probs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)
    mu = rng.standard_normal((7, 9)).astype(np.float32)
    rho = rng.normal(-3, 1, (7, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tunc.snr(_t(mu), _t(rho)).numpy(),
        np.asarray(junc.snr(jnp.asarray(mu), jnp.asarray(rho))), rtol=1e-6)


@pytest.fixture(scope="module")
def small_net_params():
    """The 2-scale net's variational parameters: JAX's tree, the port's
    dict."""
    net_j = jbuild(16, n_channels=2, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    params_j = jax.jit(lambda a, b: jvi.to_mfvi(net_j.init(a), b))(k1, k2)
    return params_j, bridge.params_from_jax(jax.tree.map(np.asarray,
                                                         params_j))


@pytest.mark.parametrize("amount", [0.0, 0.3, 0.77])
def test_prune_mask_by_snr_against_jax(small_net_params, amount):
    params_j, params_t = small_net_params
    masks_t = tunc.prune_mask_by_snr(params_t, amount)
    masks_j = bridge.params_from_jax(jax.tree.map(
        np.asarray, junc.prune_mask_by_snr(params_j, amount)))
    kernels = [n[:-3] for n in params_t if n.endswith(".w_mu")]
    assert set(masks_t) == set(kernels)
    n = zeros = 0
    for name in kernels:
        np.testing.assert_array_equal(masks_t[name].numpy(),
                                      masks_j[name].numpy())
        n += masks_t[name].numel()
        zeros += int((masks_t[name] == 0).sum())
    assert zeros == int(amount * n)
    with pytest.raises(ValueError):
        tunc.prune_mask_by_snr({"a.w": torch.ones(3)}, 0.5)


def test_normal_log_prob_is_the_vi_formula():
    assert tpriors.normal_log_prob is tvi.normal_lp


# -- Gaussian dropout ------------------------------------------------------------

@pytest.mark.parametrize("batch,stride,padding,bias", [
    (1, 1, 1, False), (1, 2, 1, True), (1, 1, 0, True), (3, 1, 1, True)])
def test_gaussian_dropout_conv_against_jax(monkeypatch, batch, stride,
                                           padding, bias):
    """Forward and gradients against JAX's with JAX's noise substituted; a
    batch-1 input runs the LRT double conv (its plain version here)."""
    rng = np.random.default_rng(20 + batch + stride + padding)
    x = rng.uniform(0, 1, (batch, 10, 12, 3)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32)
    b = rng.normal(0, 0.1, (4,)).astype(np.float32) if bias else None
    p, key = 0.3, jax.random.PRNGKey(3)

    def f_j(x_, w_):
        return jdrop.gaussian_dropout_conv(x_, w_, p, key, stride, padding,
                                           None if b is None
                                           else jnp.asarray(b))

    out_j, vjp = jax.vjp(f_j, jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(out_j.shape).astype(np.float32)
    dx_j, dw_j = vjp(jnp.asarray(g))
    eps = jax.random.normal(key, out_j.shape)
    monkeypatch.setattr(tdrop, "gaussian_eps", lambda shape, gen: _to_nc(eps))
    calls = []
    double = tlrt.double_conv
    monkeypatch.setattr(tlrt, "double_conv",
                        lambda *a: calls.append(1) or double(*a))
    xt = _to_nc(x).requires_grad_(True)
    wt = bridge.leaf_from_jax("w", w).requires_grad_(True)
    out_t = tdrop.gaussian_dropout_conv(
        xt, wt, p, torch.Generator(), stride, padding,
        None if b is None else _t(b))
    assert calls == ([1] if batch == 1 else [])
    np.testing.assert_allclose(_from_nc(out_t), np.asarray(out_j), atol=ATOL)
    out_t.backward(_to_nc(g))
    np.testing.assert_allclose(_from_nc(xt.grad), np.asarray(dx_j),
                               atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(),
                               bridge.leaf_from_jax("w", dw_j).numpy(),
                               atol=1e-4)


def test_gaussian_dropout_dense_against_jax(monkeypatch, rng):
    x = rng.standard_normal((5, 7)).astype(np.float32)
    w = rng.normal(0, 0.3, (7, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    out_j = jdrop.gaussian_dropout_dense(jnp.asarray(x), jnp.asarray(w), 0.4,
                                         key)
    eps = jax.random.normal(key, out_j.shape)
    monkeypatch.setattr(tdrop, "gaussian_eps", lambda shape, gen: _t(eps))
    out_t = tdrop.gaussian_dropout_dense(_t(x), _t(w), 0.4,
                                         torch.Generator())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)


def test_gaussian_dropout_draws_from_the_generator():
    x, w = torch.rand(1, 2, 8, 8), torch.rand(4, 2, 3, 3) - 0.5
    a = tdrop.gaussian_dropout_conv(x, w, 0.3, torch.Generator().manual_seed(1),
                                    padding=1)
    b = tdrop.gaussian_dropout_conv(x, w, 0.3, torch.Generator().manual_seed(1),
                                    padding=1)
    c = tdrop.gaussian_dropout_conv(x, w, 0.3, torch.Generator().manual_seed(2),
                                    padding=1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the SGLD family ----------------------------------------------------------------

def _tree(rng):
    """A parameter dict with one rank-4 leaf (a conv kernel) and two
    others, as numpy arrays (the same layout on both sides)."""
    return {"k": rng.normal(0, 0.1, (16, 16, 3, 3)).astype(np.float32),
            "b": rng.normal(0, 0.1, (16,)).astype(np.float32),
            "s": np.ones((16,), np.float32)}


def _run(transform_t, transform_j, steps, rng, params):
    """``steps`` updates of both with the same gradients; the updates per
    step as numpy dicts (port, JAX)."""
    p_t = {k: _t(v) for k, v in params.items()}
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    s_t, s_j = transform_t.init(p_t), transform_j.init(p_j)
    ups = []
    for _ in range(steps):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        u_t, s_t = transform_t.update({k: _t(v) for k, v in g.items()}, s_t,
                                      p_t)
        u_j, s_j = transform_j.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, s_j, p_j)
        p_t = apply_updates(p_t, u_t)
        p_j = optax.apply_updates(p_j, u_j)
        ups.append((g, {k: v.numpy() for k, v in u_t.items()},
                    {k: np.asarray(v) for k, v in u_j.items()}))
    return ups, (p_t, p_j), (s_t, s_j)


NOISE_FREE = {
    "sgld": (lambda: tsgld.sgld(1e-2, weight_decay=1e-2, addnoise=False),
             lambda: jsgld.sgld(1e-2, weight_decay=1e-2, addnoise=False)),
    "psgld in burn-in": (
        lambda: tsgld.psgld(1e-2, num_pseudo_batches=3, num_burn_in_steps=10),
        lambda: jsgld.psgld(1e-2, num_pseudo_batches=3,
                            num_burn_in_steps=10)),
    "param noise sigma 0": (
        lambda: tsgld.param_noise_transform(
            0.0, tsgld.exponential_decay_floored(1e-2, 0.9)),
        lambda: jsgld.param_noise_transform(
            0.0, jsgld.exponential_decay_floored(1e-2, 0.9))),
}


@pytest.mark.parametrize("name", sorted(NOISE_FREE))
def test_sgld_family_noise_free_against_optax(name, rng):
    make_t, make_j = NOISE_FREE[name]
    ups, (p_t, p_j), (s_t, s_j) = _run(make_t(), make_j(), 5, rng,
                                       _tree(rng))
    for _, u_t, u_j in ups:
        for k in u_t:
            assert _rel(u_t[k], u_j[k]) < STEP_REL, (name, k)
    for k in p_t:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=STEP_REL, atol=1e-9)
    if name.startswith("psgld"):
        assert int(s_t["count"]) == int(s_j.count) == 5
        for k in p_t:
            assert _rel(s_t["momentum"][k], s_j.momentum[k]) < STEP_REL


def test_sgld_noise_moments(rng):
    """update = -lr/2 g + lr N(0, 1): the noise scale is lr (the
    reference's quirk), on both sides."""
    lr = 1e-2
    ups, _, _ = _run(tsgld.sgld(lr, seed=1), jsgld.sgld(lr, seed=1), 5, rng,
                     _tree(rng))
    for g, u_t, u_j in ups:
        for u in (u_t, u_j):
            z = np.concatenate([((u[k] + lr * 0.5 * g[k]) / lr).ravel()
                                for k in g])
            assert abs(z.mean()) < 0.06 and abs(z.std() - 1) < 0.05


def test_psgld_noise_moments_after_burn_in(rng):
    lr, burn = 1e-2, 2
    ups, _, (s_t, _) = _run(tsgld.psgld(lr, num_burn_in_steps=burn, seed=2),
                            jsgld.psgld(lr, num_burn_in_steps=burn, seed=2),
                            5, rng, _tree(rng))
    # replay the preconditioner to isolate the noise term
    v = {k: np.ones_like(x) for k, x in ups[0][0].items()}
    for step, (g, u_t, u_j) in enumerate(ups, start=1):
        v = {k: v[k] + 0.05 * (g[k] * g[k] - v[k]) for k in g}
        pre = {k: 1.0 / np.sqrt(v[k] + 1e-8) for k in g}
        for u in (u_t, u_j):
            noise = np.concatenate([
                ((-u[k] / lr - 0.5 * pre[k] * g[k])
                 / (np.sqrt(pre[k]) / np.sqrt(lr))).ravel() for k in g])
            if step <= burn:
                assert np.abs(noise).max() < 1e-3
            else:
                assert abs(noise.mean()) < 0.06
                assert abs(noise.std() - 1) < 0.05
    assert s_t["generator"].device.type == "cpu"


def test_param_noise_transform_moments(rng):
    sched_t = tsgld.exponential_decay_floored(1e-2, 0.5)
    sched_j = jsgld.exponential_decay_floored(1e-2, 0.5)
    ups, _, (s_t, s_j) = _run(tsgld.param_noise_transform(2.0, sched_t),
                              jsgld.param_noise_transform(2.0, sched_j), 5,
                              rng, _tree(rng))
    for i, (g, u_t, u_j) in enumerate(ups):
        scale = 2.0 * 1e-2 * 0.5 ** i
        for u in (u_t, u_j):
            for k in ("b", "s"):            # rank 1: unchanged
                np.testing.assert_array_equal(u[k], g[k])
            z = (u["k"] - g["k"]) / scale
            assert abs(z.mean()) < 0.1 and abs(z.std() - 1) < 0.08
    assert int(s_t["count"]) == int(s_j.count) == 5


# -- the classification trainer ------------------------------------------------------

def _mlp_params_j(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    init = {"l1": {"w": jinit.conv_kernel_torch_default(k1, 1, 1, 2, 16),
                   "b": jnp.zeros((16,))},
            "l2": {"w": jinit.conv_kernel_torch_default(k2, 1, 1, 16, 2),
                   "b": jnp.zeros((2,))}}
    return jvi.to_mfvi(init, jax.random.PRNGKey(seed + 1))


def _apply_j(training_leaf):
    def apply_fn(p, x, key=None, training=True):
        h = x[:, None, None, :]
        k1 = jax.random.fold_in(key, 1) if key is not None else None
        k2 = jax.random.fold_in(key, 2) if key is not None else None
        h = jax.nn.relu(jvc.apply_conv_leaf(
            p["l1"], h, stride=1, padding=0, key=k1,
            training=training and training_leaf))
        h = jvc.apply_conv_leaf(p["l2"], h, stride=1, padding=0, key=k2,
                                training=training and training_leaf)
        return h[:, 0, 0, :]
    return apply_fn


def _apply_t(training_leaf):
    def apply_fn(p, x, generator=None, training=True):
        leaf = lambda name: {k[len(name) + 1:]: v for k, v in p.items()
                             if k.startswith(name + ".")}
        h = x[:, :, None, None]
        h = torch.relu(tvc.apply_conv_leaf(
            leaf("l1"), h, stride=1, padding=0, generator=generator,
            training=training and training_leaf))
        h = tvc.apply_conv_leaf(leaf("l2"), h, stride=1, padding=0,
                                generator=generator,
                                training=training and training_leaf)
        return h[:, :, 0, 0]
    return apply_fn


@pytest.mark.parametrize("beta_type,batch_idx", [("Blundell", 2),
                                                 ("Standard", 0),
                                                 (1e-3, 1)])
def test_elbo_step_against_jax(rng, beta_type, batch_idx):
    """One make_elbo_step with the weights' draws off, against JAX's with
    optax.adamw: loss, accuracy, the updated parameters and the moments.
    A weight decay other than optax's 1e-4 would move the parameters by
    lr * wd * p, far outside the tolerance."""
    params_j = _mlp_params_j()
    params_t = bridge.params_from_jax(jax.tree.map(np.asarray, params_j))
    x = rng.standard_normal((32, 2)).astype(np.float32)
    y = (x[:, 0] > x[:, 1]).astype(np.int32)
    lr = 5e-2
    opt_j = optax.adamw(lr)
    step_j = jcls.make_elbo_step(_apply_j(False), opt_j, 1.0, 4, beta_type)
    p_j, st_j, loss_j, acc_j = step_j(params_j, opt_j.init(params_j),
                                      jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(0), batch_idx)
    opt_t = tcls.adamw(lr)
    step_t = tcls.make_elbo_step(_apply_t(False), opt_t, 1.0, 4, beta_type)
    p_t, st_t, loss_t, acc_t = step_t(params_t, opt_t.init(params_t), _t(x),
                                      torch.from_numpy(y).long(),
                                      torch.Generator(),
                                      torch.tensor(batch_idx))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=STEP_REL)
    assert float(acc_t) == float(acc_j)
    got = bridge.params_from_jax(jax.tree.map(np.asarray, p_j))
    for name, t in p_t.items():
        assert _rel(t - params_t[name], got[name] - params_t[name]) < 1e-5, \
            name
        np.testing.assert_allclose(t.numpy(), got[name].numpy(),
                                   rtol=STEP_REL, atol=1e-8)
    mu_j = bridge.params_from_jax(jax.tree.map(np.asarray, st_j[0].mu))
    for name in p_t:
        np.testing.assert_allclose(st_t["mu"][name].numpy(),
                                   mu_j[name].numpy(), rtol=1e-5, atol=1e-10)
    assert int(st_t["count"]) == 1


def test_classification_trainer_learns(rng):
    """The port's copy of test_aux.py::test_classification_trainer_learns:
    a 2-16-2 variational MLP on a linearly separable problem, 30 epochs."""
    x = rng.standard_normal((256, 2)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, _mlp_params_j()))
    trainer = tcls.ClassificationTrainer(_apply_t(True), params, lr=5e-2,
                                         prior_sigma=1.0, n_batches=1,
                                         beta_type=1e-5, device="cpu")
    for epoch in range(30):
        trainer.train_epoch([(x, y)], torch.Generator().manual_seed(10 + epoch))
    pred = tcls.Predictor(_apply_t(True), trainer.params, n_samples=16)(x)
    assert pred.shape == (256, 2)
    np.testing.assert_allclose(pred.sum(-1).numpy(), 1.0, rtol=1e-6)
    acc = float((pred.argmax(-1).numpy() == y).mean())
    assert acc > 0.9
    assert len(trainer.log.losses) == 30
    assert trainer.log.losses[-1] < trainer.log.losses[0]


def test_trainer_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, _mlp_params_j()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcls.ClassificationTrainer(_apply_t(True), params)


def test_trainer_save_load_round_trip(tmp_path, rng):
    x = rng.standard_normal((16, 2)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, _mlp_params_j()))
    a = tcls.ClassificationTrainer(_apply_t(True), params, device="cpu")
    a.train_epoch([(x, y), (x, y)], torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.npz")
    a.save(path)
    b = tcls.ClassificationTrainer(_apply_t(True), params, device="cpu")
    b.load(path)
    for n in params:
        assert torch.equal(a.params[n], b.params[n])
        assert torch.equal(a.opt_state["mu"][n], b.opt_state["mu"][n])
        assert torch.equal(a.opt_state["nu"][n], b.opt_state["nu"][n])
    assert torch.equal(a.opt_state["count"], b.opt_state["count"])
    assert b.opt_state["count"].dtype == torch.int32
    # the loaded trainer takes the same next step
    la = a.train_epoch([(x, y)], torch.Generator().manual_seed(5))
    lb = b.train_epoch([(x, y)], torch.Generator().manual_seed(5))
    assert la == lb


def test_cross_entropy_against_jax(rng):
    logits = rng.standard_normal((9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 9).astype(np.int32)
    assert float(tcls.cross_entropy(_t(logits), torch.from_numpy(labels))) \
        == pytest.approx(float(jcls.cross_entropy(jnp.asarray(logits),
                                                  jnp.asarray(labels))),
                         rel=1e-6)


# -- losses -------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.5, 1.0])
def test_tv_loss_against_jax(rng, beta):
    x = rng.uniform(0, 1, (2, 11, 13, 3)).astype(np.float32)
    assert float(tlosses.tv_loss(_to_nc(x), beta)) == pytest.approx(
        float(jlosses.tv_loss(jnp.asarray(x), beta)), rel=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_nll_loss_2d_against_jax(rng, reduction):
    out = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 7, 9, 2)).astype(np.float32)
    assert float(tlosses.nll_loss_2d(_to_nc(out), _to_nc(tgt),
                                     reduction=reduction)) == pytest.approx(
        float(jlosses.nll_loss_2d(jnp.asarray(out), jnp.asarray(tgt),
                                  reduction=reduction)), rel=1e-5)


# -- image helpers ------------------------------------------------------------------

def test_image_helpers_against_jax(tmp_path, rng):
    img = rng.uniform(0, 1, (3, 70, 45)).astype(np.float32)
    pil_t, pil_j = timg.np_to_pil(img), jimg.np_to_pil(img)
    np.testing.assert_array_equal(np.array(pil_t), np.array(pil_j))
    np.testing.assert_array_equal(timg.pil_to_np(pil_t),
                                  jimg.pil_to_np(pil_j))
    gray = img[:1]
    np.testing.assert_array_equal(timg.pil_to_np(timg.np_to_pil(gray)),
                                  jimg.pil_to_np(jimg.np_to_pil(gray)))
    np.testing.assert_array_equal(np.array(timg.crop_image(pil_t, 16)),
                                  np.array(jimg.crop_image(pil_j, 16)))
    np.testing.assert_array_equal(timg.crop_np(img, 32),
                                  jimg.crop_np(img, 32))
    nhwc = timg.chw_to_nhwc(img)
    np.testing.assert_array_equal(timg.nhwc_to_chw(nhwc),
                                  jimg.nhwc_to_chw(nhwc))
    path = str(tmp_path / "im.png")
    pil_t.save(path)
    for size in (-1, 32, 96):
        np.testing.assert_array_equal(timg.load_image(path, size),
                                      jimg.load_image(path, size))
    np.testing.assert_array_equal(timg.get_meshgrid((5, 7)),
                                  jimg.get_meshgrid((5, 7)))
    np.testing.assert_array_equal(
        timg.add_poisson_noise(img, 3.0, np.random.default_rng(4)),
        jimg.add_poisson_noise(img, 3.0, np.random.default_rng(4)))
    np.testing.assert_array_equal(timg.put_in_center(img, (80, 64)),
                                  jimg.put_in_center(img, (80, 64)))
    for crop in (None, "CROP"):
        a = timg.load_lr_hr_imgs_sr(path, -1, 4, crop)
        b = jimg.load_lr_hr_imgs_sr(path, -1, 4, crop)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    lr = a["LR_np"]
    base_t = timg.sr_baselines(lr, a["HR_np"].shape)
    base_j = jimg.sr_baselines(lr, a["HR_np"].shape)
    for k in base_j:
        np.testing.assert_array_equal(base_t[k], base_j[k])
    np.testing.assert_array_equal(timg.normalize01(img * 3 + 1),
                                  jimg.normalize01(img * 3 + 1))
    assert np.array_equal(timg.normalize01(np.ones(4)), np.zeros(4))


def test_image_helpers_without_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((1, 4, 4), np.float32)
    for call in (lambda: timg.np_to_pil(img),
                 lambda: timg.load_image("missing.png"),
                 lambda: timg.load_lr_hr_imgs_sr("missing.png"),
                 lambda: timg.sr_baselines(img, (1, 8, 8))):
        with pytest.raises(RuntimeError, match="PIL not available"):
            call()


# -- plots and profiling ----------------------------------------------------------------

def test_histograms_and_calibration_plot_write_files(tmp_path, rng):
    mus = [rng.standard_normal((4, 3)), rng.standard_normal(5)]
    sigmas = [np.abs(rng.standard_normal((4, 3))) + 0.1,
              np.abs(rng.standard_normal(5)) + 0.1]
    paths = [str(tmp_path / f"{n}.png") for n in ("w", "snr", "conf")]
    tviz.weight_hist(mus, sigmas, paths[0], bins=10)
    tviz.snr_hist(mus, sigmas, paths[1], bins=10)
    tviz.plot_conf([0.1, 0.5, 0.9], [0.2, 0.5, 0.8], paths[2])
    for p in paths:
        assert os.path.getsize(p) > 1000


def test_profiling_on_the_cpu(tmp_path):
    pt = tprof.PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        sum(range(1000))
    s = pt.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    logdir = str(tmp_path / "trace")
    tprof.TRACER.reset()
    with tprof.trace(logdir) as prof:
        with tprof.TRACER.span("relu_mm", size=64) as span:
            torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert tprof.TRACER.spans("relu_mm") == [span]
    assert span.attrs == {"size": 64} and span.seconds >= 0
    tprof.TRACER.reset()
    trace_file = os.path.join(logdir, tprof.TRACE_FILE)
    assert os.path.getsize(trace_file) > 0
    events = json.load(open(trace_file))["traceEvents"]
    assert events
    # the span shows in the Chrome trace as a host range of its name
    assert any(e.get("name") == "relu_mm" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    tprof.debug_nans(True)
    assert torch.is_anomaly_enabled()
    tprof.debug_nans(False)
    assert not torch.is_anomaly_enabled()
