"""The port's skip U-Net (mfvi_dip_mia_tpu_torch/nn/skip.py) against the JAX
SkipNet: the same weights (carried across by utils/bridge.py) and the same RT
eps on both sides. The JAX net runs layout='auto', with the fused block off
(every conv site on the Pallas conv kernels) at 32x64, and with it on (its
default, fusing the 128-wide level) at 128^2. The port fuses every stride-1
f32 conv -> BN -> LeakyReLU site in both."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild, cf as jcf
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild, layers
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, eps_pair, jax_sample_with_eps

torch.set_num_threads(1)

# forward: the tolerance of test_skip.py's torch-transplant golden
GOLDEN = dict(atol=2e-4, rtol=1e-3)
# parameter gradients, as a share of the tree's largest gradient: the same f32
# function in another summation order (measured ~5e-7 against JAX and ~3e-7
# against an independent float64 torch net)
GRAD_REL_JAX = 1e-4
GRAD_REL_F64 = 1e-5
# LeakyReLU's slope jumps from 0.2 to 1 at 0, so a gradient comparison holds
# only where no LeakyReLU input lies within f32 rounding of 0: the two
# packages' sampled weights differ in their last bits, and an input 1e-7 from
# the kink (as one at levels.0.up1x1 was, with another input seed) can land
# on either side and move a weight gradient by 5e-4 of the largest
KINK_MARGIN = 1e-6


@pytest.fixture
def jax_fused_off(monkeypatch):
    monkeypatch.setenv("MFVI_DIP_FUSED_BLOCK", "0")


def _setup(h, w, x_seed):
    net_j = jbuild(16, n_channels=2, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    # a pytree round trip sorts dict keys, as jax.grad's and jit's outputs
    # do: take the eps walk order from the tree the functions will see
    params_j = jax.tree.map(jnp.asarray, jvi.to_mfvi(net_j.init(k1), k2))
    params_np = jax.tree.map(np.asarray, params_j)
    flat = tvi.flatten(bridge.params_from_jax(params_np))
    eps_j, eps_t = eps_pair(params_j, flat, seed=4)
    x = (np.random.default_rng(x_seed).uniform(size=(1, h, w, 16)) * 0.1
         ).astype(np.float32)
    net_t = tbuild(16, n_channels=2, **SMALL_NET)
    return net_j, params_j, eps_j, net_t, flat, eps_t, x


@pytest.fixture(scope="module")
def setup():
    return _setup(32, 64, 10)


@pytest.fixture(scope="module")
def setup128():
    return _setup(128, 128, 11)


@pytest.fixture
def count_fused(monkeypatch):
    """Counts the port's fused-block forwards (one per fused site)."""
    calls = []
    fwd = tfb.fwd

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return fwd(*args)

    monkeypatch.setattr(tfb, "fwd", spy)
    return calls


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_forward_golden_against_jax(jax_fused_off, setup):
    net_j, params_j, eps_j, net_t, flat, eps_t, x = setup
    out_j = jax.jit(lambda p: net_j.apply(
        jax_sample_with_eps(p, eps_j), jnp.asarray(x), key=None,
        training=True, layout="auto"))(params_j)
    leaves = tvi.sample_mfvi_tree(flat, eps=eps_t)
    with torch.no_grad():
        out_t = net_t(leaves, _nchw(x))
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)


def test_forward_golden_against_jax_fused_block_on(setup128, count_fused,
                                                   monkeypatch):
    """A bridged tree through the port's fused sites against the JAX net
    with its fused block on: the 128-wide level's stride-1 sites fuse on
    both sides (JAX: skip, up, up1x1; its down2 runs at 64 wide)."""
    net_j, params_j, eps_j, net_t, flat, eps_t, x = setup128
    fused_j = []
    apply_j = jfb.apply_fused

    def spy_j(*args, **kw):
        out = apply_j(*args, **kw)
        fused_j.append(out is not None)
        return out

    monkeypatch.setattr(jfb, "apply_fused", spy_j)
    out_j = jax.jit(lambda p: net_j.apply(
        jax_sample_with_eps(p, eps_j), jnp.asarray(x), key=None,
        training=True, layout="auto"))(params_j)
    assert sum(fused_j) == 3
    with torch.no_grad():
        out_t = net_t(tvi.sample_mfvi_tree(flat, eps=eps_t), _nchw(x))
    assert len(count_fused) == 8          # skip, down2, up, up1x1 per level
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)


def test_parameter_gradients_against_jax_fused_block_on(setup128):
    _check_parameter_gradients(setup128)


def test_parameter_gradients_against_jax(jax_fused_off, setup):
    _check_parameter_gradients(setup)


def _check_parameter_gradients(setup):
    net_j, params_j, eps_j, net_t, flat, eps_t, x = setup
    tgt = np.random.default_rng(6).uniform(size=x.shape[:3] + (2,)).astype(
        np.float32)

    def loss_j(p):
        out = net_j.apply(jax_sample_with_eps(p, eps_j), jnp.asarray(x),
                          key=None, training=True, layout="auto")
        return jnp.mean((out - tgt) ** 2)

    g_j = jax.jit(jax.grad(loss_j))(params_j)
    preacts = []
    sampled = tvi.sample_mfvi_tree(flat, eps=eps_t)
    _reference_net_f64({k: v.double() for k, v in sampled.items()},
                       _nchw(x).double(), net_t.n_scales, preacts)
    nearest = min(float(h.abs().min()) for h in preacts)
    assert nearest > KINK_MARGIN, f"a LeakyReLU input {nearest:.1e} from 0"
    p = flat.flat.clone().requires_grad_(True)
    out = net_t(tvi.sample_mfvi_tree(flat.with_flat(p), eps=eps_t), _nchw(x))
    torch.mean((out - _nchw(tgt)) ** 2).backward()
    g_t = flat.with_flat(p.grad).leaves()
    g_ref = bridge.params_from_jax(jax.tree.map(np.asarray, g_j))
    assert set(g_t) == set(g_ref)
    scale = max(float(v.abs().max()) for v in g_ref.values())
    for name, ref in g_ref.items():
        err = float((g_t[name] - ref).abs().max())
        assert err <= GRAD_REL_JAX * scale, (name, err, scale)


def _reference_net_f64(p, x, n_scales, preacts=None):
    """The skip U-Net written out with torch's own float64 ops (F.pad
    reflect, F.conv2d, F.batch_norm, F.interpolate): an implementation
    independent of both packages. ``preacts`` collects every LeakyReLU
    input."""
    def cba(pre, h, stride):
        w = p[pre + ".conv.w"]
        if w.shape[-1] > 1:
            h = F.pad(h, (1, 1, 1, 1), mode="reflect")
        h = F.conv2d(h, w, None, stride)
        h = F.batch_norm(h, None, None, p[pre + ".bn.scale"],
                         p[pre + ".bn.offset"], training=True, eps=1e-5)
        if preacts is not None:
            preacts.append(h.detach())
        return F.leaky_relu(h, 0.2)

    def level(i, h_in):
        pre = f"levels.{i}"
        h = cba(pre + ".down2", cba(pre + ".down1", h_in, 2), 1)
        if i < n_scales - 1:
            h = level(i + 1, h)
        h = F.interpolate(h, scale_factor=2, mode="bilinear",
                          align_corners=False)
        z = torch.cat([cba(pre + ".skip", h_in, 1), h], dim=1)
        z = F.batch_norm(z, None, None, p[pre + ".bn_cat.scale"],
                         p[pre + ".bn_cat.offset"], training=True, eps=1e-5)
        return cba(pre + ".up1x1", cba(pre + ".up", z, 1), 1)

    return F.conv2d(level(0, x), p["out.conv.w"], p["out.conv.b"])


def test_parameter_gradients_against_float64_reference(setup):
    *_, net_t, flat, eps_t, x = setup
    tgt = _nchw(np.random.default_rng(6).uniform(size=(1, 32, 64, 2)).astype(
        np.float32))
    sampled = {k: v.detach() for k, v in
               tvi.sample_mfvi_tree(flat, eps=eps_t).items()}
    p32 = {k: v.clone().requires_grad_(True) for k, v in sampled.items()}
    torch.mean((net_t(p32, _nchw(x)) - tgt) ** 2).backward()
    p64 = {k: v.double().requires_grad_(True) for k, v in sampled.items()}
    out64 = _reference_net_f64(p64, _nchw(x).double(), net_t.n_scales)
    torch.mean((out64 - tgt.double()) ** 2).backward()
    used = [k for k in p64 if p64[k].grad is not None]
    assert len(used) == len(p32) - 5 * net_t.n_scales   # biases before BN
    scale = max(float(p64[k].grad.abs().max()) for k in used)
    for k in used:
        err = float((p32[k].grad.double() - p64[k].grad).abs().max())
        assert err <= GRAD_REL_F64 * scale, (k, err, scale)


def test_batch_norm_with_a_large_channel_mean():
    """The shifted one-pass moments (nn/cf.py:58-85) stay exact where the
    raw E[x^2] - mean^2 form cancels: channel means ~50, std ~0.1."""
    rng = np.random.default_rng(7)
    x = (50.0 + 0.1 * rng.standard_normal((1, 4, 16, 32))).astype(np.float32)
    x[:, 1] -= 100.0
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    offset = rng.standard_normal(4).astype(np.float32)
    got = layers.batch_norm_train(torch.from_numpy(x), torch.from_numpy(scale),
                                  torch.from_numpy(offset)).numpy()
    ref_j = np.asarray(jcf.batch_norm_train(jnp.asarray(x), jnp.asarray(scale),
                                            jnp.asarray(offset)))
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(0, 2, 3), keepdims=True)
    var = x64.var(axis=(0, 2, 3), keepdims=True)
    exact = ((x64 - mean) / np.sqrt(var + 1e-5) * scale[None, :, None, None]
             + offset[None, :, None, None])
    # f32 normalization of values ~50: |x| * eps_f32 / std ~ 3e-4
    np.testing.assert_allclose(got, exact, atol=2e-3)
    np.testing.assert_allclose(got, ref_j, atol=1e-4)


def test_default_five_scale_net_shapes():
    net = tbuild(16, n_channels=1, pad="reflection",
                 skip_n33d=[16, 32, 64, 128, 128],
                 skip_n33u=[16, 32, 64, 128, 128], skip_n11=4, num_scales=5,
                 upsample_mode="bilinear")
    params = net.init_params(torch.Generator().manual_seed(0))
    assert net.num_conv_sites == 26
    assert sum(n.endswith(".conv.w") for n in params) == 26
    with torch.no_grad():
        out = net(params, torch.rand(1, 16, 64, 64) * 0.1)
    assert out.shape == (1, 1, 64, 64)
    assert torch.isfinite(out).all()


def test_variational_tree_in_eval_uses_the_posterior_means(jax_fused_off,
                                                           setup):
    """A variational tree applied directly (nn/var_conv.py::
    sample_rt_kernel, apply_conv_leaf): eval takes w_mu / b_mu, as the JAX
    SkipNet does; training draws from the generator."""
    net_j, params_j, _, net_t, flat, _, x = setup
    out_j = jax.jit(lambda p: net_j.apply(p, jnp.asarray(x), key=None,
                                          training=False, layout="auto"))(
        params_j)
    var = flat.leaves()
    with torch.no_grad():
        out_t = net_t(var, _nchw(x), training=False)
        drawn = net_t(var, _nchw(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)
    assert torch.isfinite(drawn).all() and not torch.equal(drawn, out_t)
    with pytest.raises(ValueError, match="generator"):
        net_t(var, _nchw(x))


@pytest.mark.parametrize("dtype,n_fused", [(torch.float32, 20),
                                           (torch.bfloat16, 20)])
def test_fused_sites_of_the_five_scale_net(count_fused, monkeypatch, dtype,
                                           n_fused):
    """f32 and bf16: the 20 stride-1 sites fuse (skip, down2, up, up1x1 at
    each of 5 levels); the 5 stride-2 down1 sites and the output conv stay
    on the conv kernel. JAX fuses no bf16 site; the port's bf16 block keeps
    f32 sums and statistics."""
    convs = []
    conv = tcf.conv_valid

    def spy(*args):
        convs.append(tuple(args[1].shape))
        return conv(*args)

    monkeypatch.setattr(tcf, "conv_valid", spy)
    net = tbuild(16, n_channels=2, pad="reflection",
                 skip_n33d=[16, 32, 64, 128, 128],
                 skip_n33u=[16, 32, 64, 128, 128], skip_n11=4, num_scales=5,
                 upsample_mode="bilinear")
    params = {k: v.to(dtype) for k, v in
              net.init_params(torch.Generator().manual_seed(0)).items()}
    with torch.no_grad():
        out = net(params, (torch.rand(1, 16, 64, 64) * 0.1).to(dtype))
    assert out.shape == (1, 2, 64, 64) and torch.isfinite(out).all()
    assert len(count_fused) == n_fused
    assert len(convs) == 26 - n_fused
