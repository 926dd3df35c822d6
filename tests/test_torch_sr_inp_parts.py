"""The sr and inp tasks' parts in the port (mfvi_dip_mia_tpu_torch/tasks/
data.py, nn/layers.py, ops/losses.py, tasks/problems.py, nn/skip.py,
ops/kernels/lrt_conv.py) against the JAX package's, on the same numpy
inputs: the synthetic images and masks bit for bit, the resizes of the sr
operator and the nearest upsample to 1e-6, the masked NLL to 1e-6 relative,
each (task, method) pair's loss, transform and metrics on one output, the
6-scale inpainting net carried across at 256^2 to test_skip.py's 2e-4, sr
mcd's N(0, 0.1) re-init in distribution, and the plain LRT double conv at
k = 5 against JAX's block-diagonal XLA conv (the path JAX's gate sends k = 5
to)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.nn.layers as JL
import mfvi_dip_mia_tpu.ops.losses as JLo
import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.problems as JP
from mfvi_dip_mia_tpu.nn import SkipNet as JSkipNet, build_skip_net as jbuild
from mfvi_dip_mia_tpu.ops.pallas import lrt_conv as jlrt
import mfvi_dip_mia_tpu_torch.nn.layers as TL
import mfvi_dip_mia_tpu_torch.ops.losses as TLo
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn.skip import SkipNet as TSkipNet, \
    build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, dropout_kwargs

torch.set_num_threads(1)

SIZE = 64
PAIRS = [(t, m) for t in ("sr", "inp") for m in ("dip", "mfvi", "mcd", "sgld")]
# the small nets the tests put in place of the full ones: sr keeps the
# 5-scale net's topology on 2 scales (SMALL_NET); inp dip / mfvi / sgld keep
# the no-skip k5 / k3 nearest topology on 3 scales (the deepest k5 site on
# 8^2, past its reflection pad of 2), inp mcd the skip-0 net on 2 scales
INP_SMALL = dict(num_channels_down=[16, 32, 32], num_channels_up=[16, 32, 32],
                 num_channels_skip=[0] * 3)
INP_MCD_SMALL = dict(skip_n33d=[16, 32], skip_n33u=[16, 32], num_scales=2)
# resizes: the same interpolation-matrix products, one rounding apart
RESIZE_ATOL = 1e-6
# losses: f32 means over the same terms in another order
LOSS_RTOL = 1e-6
# one output's metrics: MSEs relative; PSNR in dB; SSIM absolute (the blur
# is a banded-matrix product on both sides, in another order)
METRIC_TOL = dict(mse=1e-5, psnr=1e-4, ssim=1e-5)
# forward of a net carried across: test_skip.py's torch-transplant golden
GOLDEN = dict(atol=2e-4, rtol=1e-3)


def patch_small(monkeypatch, size=SIZE):
    """Both packages' sr / inp problems at size^2 on the small nets."""
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_img_superresolution", lambda i, D=D: (
            D.synthetic_mri(i, size), (size, size)))
        monkeypatch.setattr(D, "get_img_inpainting", lambda i, D=D: (
            *D.synthetic_hair(i, size), (size, size)))
    for P, build, net in ((JP, jbuild, JSkipNet), (TP, tbuild, TSkipNet)):
        monkeypatch.setattr(
            P, "_standard_net", lambda n, m, dp, input_depth=16, build=build:
            build(input_depth, n_channels=n, **SMALL_NET,
                  **dropout_kwargs(m, dp)))
        monkeypatch.setattr(P, "SkipNet", lambda net=net, **kw:
                            net(**{**kw, **INP_SMALL}))
        monkeypatch.setattr(P, "build_skip_net", lambda *a, build=build, **kw:
                            build(*a, **{**kw, **INP_MCD_SMALL}))


@pytest.fixture
def small(monkeypatch):
    patch_small(monkeypatch)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("img,size", [(0, 384), (1, 64), (3, 96)])
def test_synthetic_mri_bit_for_bit(img, size):
    np.testing.assert_array_equal(TD.synthetic_mri(img, size),
                                  JD.synthetic_mri(img, size))


@pytest.mark.parametrize("img,size", [(0, 256), (2, 64)])
def test_synthetic_hair_bit_for_bit(img, size):
    for got, ref in zip(TD.synthetic_hair(img, size),
                        JD.synthetic_hair(img, size)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.filterwarnings("ignore:.*synthetic fallback")
@pytest.mark.parametrize("img", [0, 4, 9])
def test_sr_and_inp_loaders_bit_for_bit(img, monkeypatch, tmp_path):
    monkeypatch.setenv("MFVI_DIP_DATA", str(tmp_path))    # no data files
    assert TD._SR_FILES == JD._SR_FILES and TD._INP_FILES == JD._INP_FILES
    got, size = TD.get_img_superresolution(img)
    ref, size_j = JD.get_img_superresolution(img)
    np.testing.assert_array_equal(got, ref)
    assert tuple(size) == tuple(size_j)
    got = TD.get_img_inpainting(img)
    ref = JD.get_img_inpainting(img)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert tuple(got[2]) == tuple(ref[2])
    assert got[0].shape[0] == got[1].shape[0] == 3


# -- the resizes --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("scale,hw,out_hw", [
    (0.25, (64, 48), None), (2.0, (12, 20), None), (0.25, (30, 22), (7, 6)),
    (2.0, (5, 9), (9, 17))])
def test_resize_against_jax(mode, scale, hw, out_hw):
    x = np.random.default_rng(3).standard_normal(
        (1, *hw, 2)).astype(np.float32)
    fn_t = {"nearest": TL.resize_nearest, "bilinear": TL.resize_bilinear}[mode]
    fn_j = {"nearest": JL.resize_nearest, "bilinear": JL.resize_bilinear}[mode]
    got = fn_t(_nchw(x), scale, out_hw)
    ref = np.asarray(fn_j(jnp.asarray(x), scale, out_hw))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=0, atol=RESIZE_ATOL)
    # the adjoint: the VJP of the same cotangent
    g = np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    (fn_t(xt, scale, out_hw) * _nchw(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: fn_j(v, scale, out_hw), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(vjp(jnp.asarray(g))[0]), rtol=0,
                               atol=4 * RESIZE_ATOL)


def test_nearest_x2_is_exact_and_its_adjoint_a_block_sum():
    x = torch.randn(1, 3, 5, 7, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = TL.upsample2x(x, "nearest")
    torch.testing.assert_close(y, x.repeat_interleave(2, 2).repeat_interleave(
        2, 3), rtol=0, atol=0)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    y.backward(g)
    want = g.reshape(1, 3, 5, 2, 7, 2).sum(dim=(3, 5))
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


# -- the masked NLL -----------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_gaussian_nll_masked_against_jax(reduction):
    rng = np.random.default_rng(5)
    mu = rng.uniform(0, 1, (1, 3, 16, 16)).astype(np.float32)
    # neg-logvar beyond the clamp on both sides, one channel broadcast
    nlv = (rng.standard_normal((1, 1, 16, 16)) * 15).astype(np.float32)
    target = rng.uniform(0, 1, (1, 3, 16, 16)).astype(np.float32)
    mask = (rng.uniform(size=(1, 3, 16, 16)) > 0.3).astype(np.float32)
    got = TLo.gaussian_nll_masked(*(torch.from_numpy(a) for a in (
        mu, nlv, target, mask)), reduction=reduction)
    ref = JLo.gaussian_nll_masked(*(jnp.asarray(a.transpose(0, 2, 3, 1))
                                    for a in (mu, nlv, target, mask)),
                                  reduction=reduction)
    np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)
    # the mean is over every pixel, known or not
    unmasked = TLo.gaussian_nll_masked(*(torch.from_numpy(a) for a in (
        mu, nlv, target, np.ones_like(mask))), reduction="sum")
    assert float(got) < float(unmasked)


# -- each pair's loss, transform and metrics ----------------------------------

@pytest.mark.parametrize("task,name", PAIRS)
def test_problem_against_jax(small, task, name):
    prob_j = JP.build_problem(task, name, 0, dropout_p=0.2)
    prob_t = TP.build_problem(task, name, 0, dropout_p=0.2, device="cpu")
    assert (prob_t.mean_ch, prob_t.has_ale, prob_t.sr_factor,
            prob_t.init_normal_std, tuple(prob_t.imsize)) == (
        prob_j.mean_ch, prob_j.has_ale, prob_j.sr_factor,
        prob_j.init_normal_std, tuple(prob_j.imsize))
    np.testing.assert_array_equal(prob_t.gt_np, prob_j.gt_np)
    np.testing.assert_allclose(prob_t.target_np, prob_j.target_np, rtol=0,
                               atol=RESIZE_ATOL)
    np.testing.assert_allclose(prob_t.target.numpy(), np.asarray(
        prob_j.target).transpose(0, 3, 1, 2), rtol=0, atol=RESIZE_ATOL)
    if task == "inp":
        np.testing.assert_array_equal(
            prob_t.mask.numpy(), np.asarray(prob_j.mask).transpose(0, 3, 1, 2))
        assert set(np.unique(prob_t.mask.numpy())) <= {0.0, 1.0}
    else:
        assert prob_t.mask is None and prob_j.mask is None

    n_out = {"sr": 2, "inp": 4}[task]
    rng = np.random.default_rng(6)
    outs = [(rng.standard_normal((1, SIZE, SIZE, n_out)) * 0.5 + 0.4
             ).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(
        float(prob_t.data_loss(_nchw(outs[0]))),
        float(prob_j.data_loss(jnp.asarray(outs[0]))), rtol=LOSS_RTOL)
    tr_t = [prob_t.transform(_nchw(o)) for o in outs]
    tr_j = [prob_j.transform(jnp.asarray(o)) for o in outs]
    for a, b in zip(tr_t, tr_j):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(b), rtol=1e-6, atol=0)
    got = prob_t.metrics(tr_t[0], tr_t[1]).numpy()
    ref = np.asarray(prob_j.metrics(tr_j[0], tr_j[1]))
    np.testing.assert_allclose(got[:2], ref[:2], rtol=METRIC_TOL["mse"])
    np.testing.assert_allclose(got[2:5], ref[2:5], rtol=0,
                               atol=METRIC_TOL["psnr"])
    np.testing.assert_allclose(got[5:], ref[5:], rtol=0,
                               atol=METRIC_TOL["ssim"])


def test_build_problem_takes_sr_and_inp_at_full_size():
    sr = TP.build_problem("sr", "mfvi", 0, input_depth=32, device="cpu")
    assert sr.imsize == (384, 384) and tuple(sr.target.shape) == (1, 1, 96, 96)
    assert sr.operator.func is TL.resize_nearest
    assert TP.build_problem("sr", "dip", 0, device="cpu").operator.func is \
        TL.resize_bilinear
    inp = TP.build_problem("inp", "sgld", 0, device="cpu")
    assert inp.imsize == (256, 256) and inp.mean_ch == 3
    assert inp.net.n_scales == 6 and inp.target is inp.gt
    assert TP.build_problem("inp", "mcd", 0, device="cpu").net.n_scales == 5
    with pytest.raises(ValueError, match="unknown task"):
        TP.build_problem("deblur", "dip", 0, device="cpu")


# -- the 6-scale inpainting net -----------------------------------------------

INP_NET = dict(num_output_channels=4, num_channels_skip=[0] * 6,
               filter_size_down=5, filter_size_up=3, filter_skip_size=1,
               need1x1_up=False, upsample_mode="nearest", pad="reflection",
               need_sigmoid=False)


def test_inp_net_leaf_names_and_sites_are_jax_s():
    """The full inp net: the port's leaves are the JAX tree's by name and
    shape (bridge carries them unchanged), the k5 sites are stride-2 down1 /
    stride-1 down2, and the fused block refuses k = 5."""
    widths = [16, 32, 64, 128, 128, 128]
    kw = dict(INP_NET, num_input_channels=16, num_channels_down=widths,
              num_channels_up=widths)
    net_t = TSkipNet(**kw)
    params_j = jax.eval_shape(JSkipNet(**kw).init, jax.random.PRNGKey(0))
    shapes_j = {n: tuple(v.shape) for n, v in bridge.named_leaves(params_j)}
    params_t = net_t.init_params(torch.Generator().manual_seed(0))
    assert set(params_t) == set(shapes_j)
    for n, v in params_t.items():
        s = shapes_j[n]
        assert tuple(v.shape) == ((s[3], s[2], s[0], s[1]) if len(s) == 4
                                  else s), n
    assert [(c.down1.kernel, c.down1.stride, c.down2.kernel, c.up.kernel,
             c.skip_conv, c.up1x1) for c in net_t.levels] == \
        [(5, 2, 5, 3, None, None)] * 6
    x = torch.zeros(1, 16, 4, 4)
    assert not tfb.supported(x, 5) and tfb.supported(x, 3)


def test_inp_6scale_forward_against_jax_at_256(monkeypatch):
    """The 6-scale no-skip k5 / k3 net at narrow widths on 256^2, the least
    size whose deepest k5 site (4^2) takes its reflection pad of 2: one
    train-mode forward of weights carried across from JAX. Every k5 stride-2
    site runs as the k3 parity-plane conv, every k5 stride-1 site as the
    plain conv with the unfused BN chain, every k3 up site as the fused
    block."""
    widths = [4, 8, 8, 8, 8, 8]
    kw = dict(INP_NET, num_input_channels=8, num_channels_down=widths,
              num_channels_up=widths)
    net_j = JSkipNet(**kw)
    params_np = jax.tree.map(np.asarray,
                             jax.jit(net_j.init)(jax.random.PRNGKey(7)))
    x = (np.random.default_rng(8).uniform(size=(1, 256, 256, 8)) * 0.1
         ).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: net_j.apply(p, x, training=True))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(x)))
    seen, fused = [], []
    conv, fwd = tcf.conv_valid, tfb.fwd
    monkeypatch.setattr(tcf, "conv_valid", lambda xp, w: (
        seen.append(w.shape[2]), conv(xp, w))[1])
    monkeypatch.setattr(tfb, "fwd", lambda *a: (
        fused.append(tuple(a[1].shape[2:])), fwd(*a))[1])
    got = TSkipNet(**kw)(bridge.params_from_jax(params_np), _nchw(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               ref, **GOLDEN)
    # 6 plane convs (k3 on 4C planes), 6 k5 convs and the 1x1 output conv;
    # the 6 k3 up sites fused
    assert sorted(seen) == [1] + [3] * 6 + [5] * 6
    assert fused == [(3, 3)] * 6


# -- sr mcd's re-init ---------------------------------------------------------

def test_sr_mcd_reinit_statistics():
    """Every conv kernel of sr mcd's 5-scale net is N(0, 0.1) (JAX's draw
    differs, its distribution does not); biases and the BN affine are the
    torch-default init's, and no other pair re-draws."""
    prob = TP.build_problem("sr", "mcd", 0, input_depth=32, device="cpu")
    got = TT.init_params(prob, TT.Method("mcd"), 3)
    base = prob.net.init_params(torch.Generator().manual_seed(3))
    kernels = [k for k in got if k.endswith(".conv.w")]
    assert len(kernels) == prob.net.num_conv_sites == 26
    pooled = torch.cat([got[k].reshape(-1) for k in kernels])
    assert abs(float(pooled.std()) - 0.1) < 0.002
    assert abs(float(pooled.mean())) < 0.002
    for k in kernels:
        if got[k].numel() >= 4096:
            assert abs(float(got[k].std()) - 0.1) < 0.01, k
    for k, v in got.items():
        if k not in kernels:
            torch.testing.assert_close(v, base[k], rtol=0, atol=0)
    # JAX's own re-init (on the 2-scale net) has the same statistics
    net_j = jbuild(32, n_channels=2, **SMALL_NET)
    re_j = jax.jit(lambda k: JP.reinit_conv_weights_normal(
        net_j.init(k), jax.random.PRNGKey(4), 0.1))(jax.random.PRNGKey(3))
    pooled_j = np.concatenate([np.asarray(v).reshape(-1) for n, v in
                               bridge.named_leaves(re_j)
                               if n.endswith(".conv.w")])
    assert pooled_j.size > 30_000
    assert abs(float(pooled_j.std()) - 0.1) < 0.002
    for name in ("mfvi", "sgld", "dip"):
        assert TP.build_problem("sr", name, 0, device="cpu"
                                ).init_normal_std is None


# -- the LRT double conv at k = 5 ---------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_lrt_double_conv_k5_against_jax_xla(stride):
    """The port's plain double conv at inp's k5 sites (stride 1 as it is,
    stride 2 on k3 parity planes) against JAX's block-diagonal XLA conv,
    where its Pallas gate sends k = 5; forward and the VJP, to the LRT
    tests' 1e-4 of the largest value."""
    rng = np.random.default_rng(9 + stride)
    x = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    w_mu = (rng.standard_normal((5, 5, 8, 12)) * 0.1).astype(np.float32)
    w_var = rng.uniform(0.001, 0.01, (5, 5, 8, 12)).astype(np.float32)
    oihw = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            for w in (w_mu, w_var)]
    xt = _nchw(x).requires_grad_(True)
    wt = [w.clone().requires_grad_(True) for w in oihw]
    xp = torch.nn.functional.pad(xt, (2,) * 4)[0]
    got = tlrt.double_conv(xp, *wt, stride)

    def jax_fn(x, w_mu, w_var):
        return jlrt._fused_double_conv(x, w_mu, w_var, stride, 2)

    ref, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (x, w_mu, w_var)))
    g = [rng.standard_normal(np.asarray(r).shape).astype(np.float32)
         for r in ref]
    for a, b in zip(got, ref):
        b = np.asarray(b)[0].transpose(2, 0, 1)
        assert a.shape == b.shape
        assert float((a.detach() - torch.from_numpy(b)).abs().max()) <= \
            1e-4 * float(np.abs(b).max())
    sum(((a * torch.from_numpy(np.ascontiguousarray(
        gg[0].transpose(2, 0, 1)))).sum() for a, gg in zip(got, g))
        ).backward()
    grads_j = vjp(tuple(jnp.asarray(gg) for gg in g))
    for a, b in zip((xt.grad.numpy().transpose(0, 2, 3, 1),
                     wt[0].grad.numpy().transpose(2, 3, 1, 0),
                     wt[1].grad.numpy().transpose(2, 3, 1, 0)), grads_j):
        b = np.asarray(b)
        assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
