"""The sr and inp tasks under all four methods through the port's ``fit``
(mfvi_dip_mia_tpu_torch/tasks/trainer.py) against the JAX package's ``fit``
in lockstep, at 64^2 (sr: 16^2 low resolution) on the small nets of
test_torch_sr_inp_parts.py (sr: the 2-scale skip net; inp: the no-skip k5 /
k3 nearest net on 3 scales, mcd the skip-0 net on 2).

Both sides start from the same deterministic parameters (carried across by
utils/bridge.py; sr mcd's N(0, 0.1) re-init drawn once by JAX and carried
across too, since the two packages' streams differ), see the same fixed DIP
input, run with the input jitter off and, since the JAX step is traced once,
one fixed table per random draw reused every step: mfvi's RT eps
(torch_port_helpers.eps_pair), mcd's dropout2d keep masks (MaskTable) and
sgld's parameter noise (NoiseTable). The JAX side runs its default
layout='nhwc' on its CPU operators. Tolerance: the MFVI lockstep's
2e-3 * (1 + i) dB per iteration; SSIM to 1e-3."""

import weakref

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.bayes.vi as jvi
import mfvi_dip_mia_tpu.nn.skip as JS
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.nn.layers as TL
import mfvi_dip_mia_tpu_torch.optim.sgld as TS
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_torch_sr_inp_parts import PAIRS, SIZE, patch_small
from test_torch_trainer import _psnr_tol
from torch_port_helpers import MaskTable, NoiseTable, eps_pair, \
    jax_sample_with_eps

torch.set_num_threads(1)

N_STEPS = 4
LR = 1e-3
# as test_torch_methods_fit.py: a weight decay large enough to show, den
# sgld's decayed lr halving every step (sr and inp decay as den does)
WEIGHT_DECAY = 5.0
DROPOUT_P = 0.3
GAMMA = 0.5
# down1, down2, up and up1x1 at each of the 2 levels of both mcd nets
DROPOUT_SITES = 8
# mfvi: test_mfvi_den's prior
TEMP, SIGMA = 5.66e-7, 1.46e-5


def method(module, name):
    if name == "mfvi":
        return module.Method("mfvi", temp=TEMP, sigma=SIGMA)
    return module.Method(name, dropout_p=DROPOUT_P,
                         weight_decay=WEIGHT_DECAY, gamma=GAMMA)


@pytest.fixture
def lockstep(monkeypatch):
    patch_small(monkeypatch)
    for T in (JT, TT):
        monkeypatch.setattr(T, "REG_NOISE_STD", 0.0)
    # the compiled chunk runner is cached per net structure for the whole
    # process and its key does not cover a patched noise source
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE", {})
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE_WEAK",
                        weakref.WeakKeyDictionary())

    def setup(task, name):
        prob_j = JP.build_problem(task, name, 0, input_depth=16,
                                  dropout_p=DROPOUT_P)
        prob_t = TP.build_problem(task, name, 0, input_depth=16,
                                  dropout_p=DROPOUT_P, device="cpu")
        k1, k2 = jax.random.split(jax.random.PRNGKey(21))
        params = prob_j.net.init(k1)
        if prob_j.init_normal_std is not None:
            params = JP.reinit_conv_weights_normal(params, k2,
                                                   prob_j.init_normal_std)
        if name == "mfvi":
            params = jvi.to_mfvi(params, k2)
        # a pytree round trip sorts dict keys, as the jitted step sees them
        params_j = jax.tree.map(jnp.asarray, params)
        params_np = jax.tree.map(np.asarray, params_j)
        monkeypatch.setattr(
            JT, "_get_init_fn", lambda problem, m, optimizer, std:
            (lambda *keys: (params_j, optimizer.init(params_j))))
        monkeypatch.setattr(TT, "init_params", lambda problem, m, seed:
                            bridge.params_from_jax(params_np))
        if name == "mfvi":
            flat = tvi.flatten(bridge.params_from_jax(params_np))
            eps_j, eps_t = eps_pair(params_j, flat, seed=22)
            monkeypatch.setattr(
                jvi, "sample_mfvi_tree", lambda p, key, out_dtype=None:
                jax_sample_with_eps(p, eps_j, out_dtype))
            sample = tvi.sample_mfvi_tree
            monkeypatch.setattr(
                tvi, "sample_mfvi_tree",
                lambda p, generator=None, out_dtype=None, eps=None:
                sample(p, out_dtype=out_dtype, eps=eps_t))
        if name == "mcd":
            table = MaskTable(23, DROPOUT_SITES)
            monkeypatch.setattr(TL, "dropout_keep", table.port_keep)
            for ops, last in ((JS._NHWCOps, True), (JS._CFOps, False)):
                monkeypatch.setattr(ops, "dropout2d", staticmethod(
                    table.jax_dropout2d(channels_last=last)))
        if name == "sgld":
            noise = NoiseTable(params_np, 24)
            monkeypatch.setattr(JT, "add_param_noise",
                                noise.jax_add_param_noise)
            monkeypatch.setattr(TS, "param_noise_eps", noise.port_eps(
                tvi.flatten(bridge.params_from_jax(params_np))))
        return prob_j, prob_t

    return setup


@pytest.mark.parametrize("task,name", PAIRS)
def test_fit_lockstep_against_jax(lockstep, task, name):
    prob_j, prob_t = lockstep(task, name)
    kw = dict(num_iter=N_STEPS - 1, lr=LR, seed=1, show_every=N_STEPS,
              metrics_every=1)
    res_t = TT.fit(prob_t, method(TT, name), device="cpu", **kw)
    res_j = JT.fit(prob_j, method(JT, name), **kw)
    assert res_t.psnrs.shape == res_j.psnrs.shape == (N_STEPS, 3)
    np.testing.assert_array_equal(res_t.net_input, res_j.net_input)
    for i in range(N_STEPS):
        for col in range(3):
            assert abs(res_t.psnrs[i, col] - res_j.psnrs[i, col]) < \
                _psnr_tol(i), (i, col, res_t.psnrs[i], res_j.psnrs[i])
    np.testing.assert_allclose(res_t.mse_gt, res_j.mse_gt, rtol=1e-3)
    # the fit moved: the lockstep compares dynamics, not a fixed point (sr
    # sgld's halving lr moves the PSNR against the low-resolution target,
    # column 0, ~10x more than the one against the ground truth in 4 steps)
    assert np.abs(res_t.psnrs[-1, :2] - res_t.psnrs[0, :2]).max() > \
        10 * _psnr_tol(N_STEPS)
    assert abs(res_t.final_psnr - res_j.final_psnr) < _psnr_tol(N_STEPS)
    np.testing.assert_allclose(res_t.ssims, res_j.ssims, atol=1e-3)
    mc = {"sr": 1, "inp": 3}[task]
    for f in ("recons", "uncerts_epi", "uncerts_ale"):
        got, ref = getattr(res_t, f), getattr(res_j, f)
        assert got.shape == ref.shape == (2, mc, SIZE, SIZE), f
        # dip keeps no uncertainty maps; the other methods fill theirs
        assert (np.abs(got).max() == 0) == (np.abs(ref).max() == 0), f
    np.testing.assert_allclose(res_t.recons, res_j.recons, rtol=0, atol=2e-3)

