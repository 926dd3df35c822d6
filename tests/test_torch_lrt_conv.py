"""The port's LRT double conv (mfvi_dip_mia_tpu_torch/ops/kernels/lrt_conv.py)
against the JAX package's: the plain forward and the autograd backward
against the block-diagonal XLA conv (lrt_conv.py::_fused_double_conv) and the
Pallas kernel in interpret mode (lrt_conv_pallas.py::lrt_double_conv_pallas),
at test_lrt_pallas.py's cases; stride 2 through the parity planes; and the
sampled conv ``lrt_conv`` with JAX's own eps. Same numpy inputs on both
sides, NHWC / HWIO there and NCHW / OIHW here."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.ops.pallas import lrt_conv as jlrt
from mfvi_dip_mia_tpu.ops.pallas import lrt_conv_pallas as jlp
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

torch.set_num_threads(1)

# test_lrt_pallas.py's CASES: (H, W, C, O, k, pad), the skip net's stride-1
# conv shapes
CASES = [(32, 32, 16, 16, 3, 1), (16, 64, 32, 64, 3, 1),
         (16, 32, 128, 128, 3, 1), (32, 32, 64, 4, 1, 0)]
# the JAX test's own bound (test_lrt_pallas.py:43, :65): the same f32 sums in
# another order, as a share of the JAX result's largest magnitude
REL = 1e-4
JAX_DOUBLE_CONVS = {"xla": jlrt._fused_double_conv,
                    "pallas": jlp.lrt_double_conv_pallas}


def _mats(h, w, c, o, k, seed):
    """test_lrt_pallas.py::_mats: x (1, H, W, C), w_mu and w_var HWIO."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    w_mu = (rng.standard_normal((k, k, c, o)) * 0.1).astype(np.float32)
    w_var = rng.uniform(0.001, 0.01, (k, k, c, o)).astype(np.float32)
    return x, w_mu, w_var


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _assert_close(got_nchw, ref_nhwc):
    ref = np.asarray(ref_nhwc)
    got = got_nchw.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= REL * float(np.max(np.abs(ref))), (err, ref.shape)


def _port_site(x, w_mu, w_var, stride, pad):
    """The port's double conv of one zero-padded site, batch-1 NCHW."""
    xp = F.pad(x, (pad,) * 4)[0]
    mu, var = tlrt.double_conv(xp, w_mu, w_var, stride)
    return mu[None], var[None]


@pytest.mark.parametrize("jax_fn", sorted(JAX_DOUBLE_CONVS))
@pytest.mark.parametrize("h,w,c,o,k,pad", CASES)
def test_double_conv_forward_matches_jax(jax_fn, h, w, c, o, k, pad):
    x, w_mu, w_var = _mats(h, w, c, o, k, 0)
    if jax_fn == "pallas":
        assert jlp.supported(jnp.asarray(x), jnp.asarray(w_mu), 1, pad)
    mu_j, var_j = JAX_DOUBLE_CONVS[jax_fn](jnp.asarray(x), jnp.asarray(w_mu),
                                           jnp.asarray(w_var), 1, pad)
    mu_t, var_t = _port_site(_nchw(x), _oihw(w_mu), _oihw(w_var), 1, pad)
    _assert_close(mu_t, mu_j)
    _assert_close(var_t, var_j)


def _grads_jax(fn, x, w_mu, w_var, g_mu, g_var, stride, pad):
    def scalar(x_, wm_, wv_):
        mu, var = fn(x_, wm_, wv_, stride, pad)
        return jnp.sum(mu * g_mu) + jnp.sum(var * g_var)
    return jax.grad(scalar, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_var))


def _grads_port(x, w_mu, w_var, g_mu, g_var, stride, pad):
    xt = _nchw(x).requires_grad_(True)
    wm = _oihw(w_mu).requires_grad_(True)
    wv = _oihw(w_var).requires_grad_(True)
    mu, var = _port_site(xt, wm, wv, stride, pad)
    (torch.sum(mu * _nchw(g_mu)) + torch.sum(var * _nchw(g_var))).backward()
    return xt.grad, wm.grad, wv.grad


def _assert_grads(got, ref):
    gx, gwm, gwv = got
    _assert_close(gx, ref[0])
    for g_t, g_j in ((gwm, ref[1]), (gwv, ref[2])):
        ref_oihw = np.asarray(g_j).transpose(3, 2, 0, 1)
        err = float(np.max(np.abs(g_t.numpy() - ref_oihw)))
        assert err <= REL * float(np.max(np.abs(ref_oihw))), err


@pytest.mark.parametrize("jax_fn", sorted(JAX_DOUBLE_CONVS))
def test_double_conv_gradients_match_jax(jax_fn):
    """x, w_mu and w_var gradients through the port's autograd.Function
    against jax.grad, at test_lrt_pallas.py::test_gradients_match_xla's
    shape and seeds."""
    h, w, c, o, k, pad = 16, 32, 16, 8, 3, 1
    x, w_mu, w_var = _mats(h, w, c, o, k, 1)
    rng = np.random.default_rng(2)
    g_mu = rng.standard_normal((1, h, w, o)).astype(np.float32)
    g_var = rng.standard_normal((1, h, w, o)).astype(np.float32)
    ref = _grads_jax(JAX_DOUBLE_CONVS[jax_fn], x, w_mu, w_var, g_mu, g_var,
                     1, pad)
    _assert_grads(_grads_port(x, w_mu, w_var, g_mu, g_var, 1, pad), ref)


@pytest.mark.parametrize("h,w,c,o,k,pad", [(16, 32, 16, 32, 3, 1),
                                           (15, 17, 8, 16, 3, 1),
                                           (16, 16, 8, 8, 1, 0)])
def test_stride2_double_conv_matches_jax(h, w, c, o, k, pad):
    """Stride 2 on the parity planes (k3, an odd size) and as a subsample
    (k1), forward and gradients, against _fused_double_conv at stride 2."""
    x, w_mu, w_var = _mats(h, w, c, o, k, 3)
    mu_j, var_j = jlrt._fused_double_conv(jnp.asarray(x), jnp.asarray(w_mu),
                                          jnp.asarray(w_var), 2, pad)
    mu_t, var_t = _port_site(_nchw(x), _oihw(w_mu), _oihw(w_var), 2, pad)
    _assert_close(mu_t, mu_j)
    _assert_close(var_t, var_j)
    rng = np.random.default_rng(4)
    g_mu = rng.standard_normal(mu_j.shape).astype(np.float32)
    g_var = rng.standard_normal(mu_j.shape).astype(np.float32)
    ref = _grads_jax(jlrt._fused_double_conv, x, w_mu, w_var, g_mu, g_var, 2,
                     pad)
    _assert_grads(_grads_port(x, w_mu, w_var, g_mu, g_var, 2, pad), ref)


@pytest.mark.parametrize("stride,pallas", [(1, False), (1, True), (2, False)])
def test_sampled_conv_matches_jax(monkeypatch, stride, pallas):
    """lrt_conv with the eps JAX draws (jax.random.normal(key, shape),
    transposed to NCHW) against JAX's lrt_conv, biases included."""
    x, w_mu, w_var = _mats(16, 32, 16, 8, 3, 5)
    w_rho = np.log(np.expm1(np.sqrt(w_var))).astype(np.float32)
    rng = np.random.default_rng(6)
    b_mu = (0.1 * rng.standard_normal(8)).astype(np.float32)
    b_rho = rng.uniform(-6.0, -3.0, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    if pallas:
        monkeypatch.setenv("MFVI_DIP_PALLAS_LRT", "1")
    else:
        monkeypatch.delenv("MFVI_DIP_PALLAS_LRT", raising=False)
    out_j = jlrt.lrt_conv(jnp.asarray(x), jnp.asarray(w_mu),
                          jnp.asarray(w_rho), jnp.asarray(b_mu),
                          jnp.asarray(b_rho), stride, 1, key)
    eps = np.asarray(jax.random.normal(key, out_j.shape, jnp.float32))
    out_t = tlrt.lrt_conv(_nchw(x), _oihw(w_mu), _oihw(w_rho),
                          torch.from_numpy(b_mu), torch.from_numpy(b_rho),
                          stride, 1, "zero", _nchw(eps))
    _assert_close(out_t, out_j)


def test_bf16_input_returns_bf16():
    """A bf16 site computes in f32 and returns bf16, as the TPU wrapper
    casts its f32 results to x's dtype (lrt_conv_pallas.py:161-167)."""
    x, w_mu, w_var = _mats(8, 16, 8, 8, 3, 8)
    xp = F.pad(_nchw(x), (1,) * 4)[0]
    args = [t.to(torch.bfloat16) for t in (xp, _oihw(w_mu), _oihw(w_var))]
    mu, var = tlrt.double_conv_fwd(*args)
    mu32, var32 = tlrt.fused_double_conv(*[a.float() for a in args])
    assert mu.dtype == var.dtype == torch.bfloat16
    assert torch.equal(mu, mu32.to(torch.bfloat16))
    assert torch.equal(var, var32.to(torch.bfloat16))


def test_shape_checks():
    xp = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError, match="differ"):
        tlrt.double_conv_fwd(xp, torch.zeros(2, 4, 3, 3),
                             torch.zeros(2, 4, 1, 1))
    with pytest.raises(ValueError, match="square kernel"):
        tlrt.double_conv_fwd(xp, torch.zeros(2, 4, 5, 5),
                             torch.zeros(2, 4, 5, 5))
