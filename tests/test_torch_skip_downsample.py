"""The port's pooled skip nets (nn/skip.py ``downsample_mode``) against the
JAX package's: the train-mode forward of the 2-scale net under avg, max,
lanczos2 and lanczos3 with the same weights and RT eps, the sites' bias and
fusion plan, and a den/MFVI lockstep of the lanczos2 net against the JAX
``fit`` (the locksteps of tests/test_torch_trainer.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.nn.skip import SkipNet as JSkipNet
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.nn.skip import SkipNet as TSkipNet
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, dropout_kwargs, eps_pair, \
    jax_sample_with_eps
from test_torch_trainer import LR, PRIORS, _lockstep

torch.set_num_threads(1)

MODES = ("avg", "max", "lanczos2", "lanczos3")
# the transplant golden's tolerance (tests/test_skip.py, test_torch_skip.py)
GOLDEN = dict(atol=2e-4, rtol=1e-3)
N_STEPS = 10


def _psnr_tol(i):
    return 2e-3 * (1 + i)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _setup(mode):
    net_j = jbuild(16, n_channels=2, downsample_mode=mode, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(31))
    params_j = jax.tree.map(jnp.asarray, jvi.to_mfvi(net_j.init(k1), k2))
    params_np = jax.tree.map(np.asarray, params_j)
    flat = tvi.flatten(bridge.params_from_jax(params_np))
    eps_j, eps_t = eps_pair(params_j, flat, seed=32)
    x = (np.random.default_rng(33).uniform(size=(1, 32, 64, 16)) * 0.1
         ).astype(np.float32)
    net_t = tbuild(16, n_channels=2, downsample_mode=mode, **SMALL_NET)
    return net_j, params_j, eps_j, net_t, flat, eps_t, x


@pytest.fixture
def jax_fused_off(monkeypatch):
    monkeypatch.setenv("MFVI_DIP_FUSED_BLOCK", "0")


@pytest.mark.parametrize("mode", MODES)
def test_pooled_forward_golden_against_jax(jax_fused_off, mode):
    net_j, params_j, eps_j, net_t, flat, eps_t, x = _setup(mode)
    out_j = jax.jit(lambda p: net_j.apply(
        jax_sample_with_eps(p, eps_j), jnp.asarray(x), key=None,
        training=True, layout="auto"))(params_j)
    with torch.no_grad():
        out_t = net_t(tvi.sample_mfvi_tree(flat, eps=eps_t), _nchw(x))
    assert out_t.shape == (1, 2, 32, 64)
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)


@pytest.mark.parametrize("mode", MODES + ("stride",))
def test_pooled_site_plan_against_jax(jax_fused_off, monkeypatch, mode):
    """Which sites keep their bias (JAX's rule, skip.py:325-327: a Lanczos
    down1 site keeps it, an avg or max one does not) and which fuse: every
    stride-1 site, and no pooled one, whose declared stride is 2."""
    net_j, params_j, eps_j, net_t, flat, eps_t, x = _setup(mode)
    seen_j, seen_t, fused = {}, {}, []
    site_j, site_t, fwd = JSkipNet._conv_site, TSkipNet._conv_site, tfb.fwd

    def spy_j(self, s, *args, skip_bias=False, **kw):
        seen_j[s.site_id] = skip_bias
        return site_j(self, s, *args, skip_bias=skip_bias, **kw)

    def spy_t(self, s, params, prefix, x, generator, training, reparam,
              dropout_p=None, skip_bias=False):
        seen_t[s.site_id] = (skip_bias, tuple(x.shape))
        return site_t(self, s, params, prefix, x, generator, training,
                      reparam, dropout_p, skip_bias)

    monkeypatch.setattr(JSkipNet, "_conv_site", spy_j)
    monkeypatch.setattr(TSkipNet, "_conv_site", spy_t)
    monkeypatch.setattr(tfb, "fwd", lambda *a: fused.append(1) or fwd(*a))
    # traced once: the spy records each site's static skip_bias
    jax.eval_shape(lambda p: net_j.apply(
        jax_sample_with_eps(p, eps_j), jnp.asarray(x), key=None,
        training=True, layout="auto"), params_j)
    with torch.no_grad():
        net_t(tvi.sample_mfvi_tree(flat, eps=eps_t), _nchw(x))
    down1 = {cfg.down1.site_id for cfg in net_t.levels}
    out_id = net_t.out_conv.site_id
    # the port runs the down1 sites and the output conv unfused, and fuses
    # the 8 stride-1 sites (skip, down2, up, up1x1 per level)
    assert set(seen_t) == down1 | {out_id}
    assert len(fused) == 8
    for sid in down1:
        assert seen_t[sid][0] == seen_j[sid], (mode, sid)
        assert seen_t[sid][0] == (mode in ("stride", "avg", "max"))
    assert seen_t[out_id][0] is False and seen_j[out_id] is False
    assert net_t.downsamplers.keys() == (
        down1 if mode.startswith("lanczos") else set())
    if mode != "stride":
        # a pooled site convolves its level's full resolution
        assert seen_t[net_t.levels[1].down1.site_id][1] == (1, 16, 16, 32)


def test_unknown_downsample_mode_raises():
    with pytest.raises(ValueError, match="wrong kernel name 'bicubic'"):
        tbuild(16, n_channels=2, downsample_mode="bicubic", **SMALL_NET)
    with pytest.raises(ValueError, match="wrong kernel name 'gauss'"):
        tbuild(16, n_channels=2, downsample_mode=["avg", "gauss"],
               **SMALL_NET)


def test_per_scale_downsample_modes():
    net = tbuild(16, n_channels=2, downsample_mode=["lanczos3", "max"],
                 **SMALL_NET)
    assert [c.down1.downsample_mode for c in net.levels] == ["lanczos3",
                                                             "max"]
    assert list(net.downsamplers) == [net.levels[0].down1.site_id]
    assert all(c.down2.downsample_mode == "stride" for c in net.levels)


def test_lanczos2_den_lockstep_against_jax(monkeypatch):
    """den/MFVI at 64^2 on the 2-scale lanczos2 net: the port's fit and the
    JAX fit from the same parameters, input and RT eps, 10 steps."""
    setup = _lockstep(monkeypatch, 64, jax_fused=False)
    monkeypatch.setattr(JP, "_standard_net", lambda n, m, dp, input_depth=16:
                        jbuild(input_depth, n_channels=n, **SMALL_NET,
                               downsample_mode="lanczos2",
                               **dropout_kwargs(m, dp)))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, **SMALL_NET,
                               downsample_mode="lanczos2",
                               **dropout_kwargs(m, dp)))
    prob_j, prob_t = setup("den")
    assert prob_t.net.downsamplers and prob_j.net.levels[0].down1 \
        .downsample_mode == "lanczos2"
    temp, sigma = PRIORS["den"]
    kw = dict(num_iter=N_STEPS - 1, lr=LR, seed=1, show_every=N_STEPS)
    res_t = TT.fit(prob_t, TT.Method("mfvi", temp=temp, sigma=sigma),
                   device="cpu", **kw)
    res_j = JT.fit(prob_j, JT.Method("mfvi", temp=temp, sigma=sigma),
                   layout="auto", **kw)
    assert res_t.psnrs.shape == res_j.psnrs.shape == (N_STEPS, 3)
    for i in range(N_STEPS):
        for col in range(3):
            assert abs(res_t.psnrs[i, col] - res_j.psnrs[i, col]) < \
                _psnr_tol(i), (i, col, res_t.psnrs[i], res_j.psnrs[i])
    # the fit moves: the lockstep is not held by two frozen nets
    assert abs(res_t.psnrs[-1, 1] - res_t.psnrs[0, 1]) > 10 * _psnr_tol(
        N_STEPS)
